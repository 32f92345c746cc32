"""A throwaway copy of the benchmark with one tiny cell that the CPU runs
in seconds: the canonical configuration at hidden 32, 8 fake-engine envs,
batch 16, 2 updates an iteration, a 64-column ring, the limits of
``canonical-b1024``. It is added as new files and new entries only."""
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def copy_bench(root: Path) -> Path:
    """Copy BENCHMARK.json and port_bench/ (without its tests) under
    ``root``; returns the copy's port_bench."""
    bench = root / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return bench


def add_tiny_cell(root: Path, limits_of: str = "canonical-b1024") -> Path:
    """Copy BENCHMARK.json and port_bench/ under ``root`` and add the cell
    ``tiny`` as new files and entries; returns the copy's port_bench."""
    bench = copy_bench(root)
    m = json.loads((root / "BENCHMARK.json").read_text())
    c = json.loads((bench / "configs" / "rainbow-canonical.json").read_text())
    c["name"] = "tiny"
    c["settings"].update(hidden_size=32, memory_capacity=512, learn_start=96,
                         target_update=64, evaluation_size=10)
    (bench / "configs" / "tiny.json").write_text(json.dumps(c))
    t = {"name": "tiny", "settings": {
        "game": "pong", "env_backend": "fake", "num_envs": 8,
        "batch_size": 16, "replay_frequency": 4}}
    (bench / "traffic" / "tiny.json").write_text(json.dumps(t))
    shutil.copy(bench / "limits" / f"{limits_of}.json",
                bench / "limits" / "tiny.json")
    m["configs"].append({"name": "tiny", "source": "test",
                         "file": "port_bench/configs/tiny.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "test"})
    for pl in m["per_layer"]:
        pl.setdefault("workloads", []).append("tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return bench


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return add_tiny_cell(tmp_path_factory.mktemp("bench"))
