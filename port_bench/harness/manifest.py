"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic mix and each per-layer metric; the files live under
``port_bench/`` by those names:

    configs/<config>.json   the configuration: its CLI settings, source, cuts
    traffic/<traffic>.json  the traffic mix: envs, batch, cadence, loop, game
    limits/<cell>.json      the limit of each number that decides ``correct``
    metrics/<metric>.py     a per-layer metric's reader
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def resolve(manifest: dict, cell: str, bench: Path = BENCH) -> dict:
    """Everything a run of ``cell`` reads: its manifest entry, its config,
    traffic and limits, the end-to-end metrics it reports and the per-layer
    metrics whose ``workloads`` name it (or that name none)."""
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if cell not in by_name:
        raise KeyError(f"no workload {cell!r}; have {sorted(by_name)}")
    w = by_name[cell]
    configs = {c["name"]: c for c in manifest["configs"]}
    entry = configs[w["config"]]

    def here(m):
        return "workloads" not in m or cell in m["workloads"]

    return {
        "workload": w,
        "config_entry": entry,
        "config": _json(bench.parent / entry["file"]),
        "traffic": _json(bench / "traffic" / f"{w['traffic']}.json"),
        "limits": _json(bench / "limits" / f"{cell}.json"),
        "end_to_end": [m for m in manifest["end_to_end"] if here(m)],
        "per_layer": [m for m in manifest["per_layer"] if here(m)],
        "bench": bench,
    }


def load_metric(name: str, bench: Path = BENCH):
    """The reader module of per-layer metric ``name``
    (metrics/<name>.py, loaded from its path: names hold dots)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_name = "port_bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
