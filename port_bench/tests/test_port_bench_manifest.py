"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name; a throwaway cell added as new files only is found too."""
import hashlib
import json
import re

import pytest

from port_bench.harness import manifest as mf
from port_bench.reference.check import NUMBERS
from port_bench.tests.conftest import BENCH, ROOT, add_tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["port_bench"]
    assert M["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= M["run_seconds"] <= 51


def test_names_units_and_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in M[section]]
        assert len(set(names)) == len(names)
        for e in M[section]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for e in M["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert any(e["name"] == "setup_s" for e in M["end_to_end"])
    e2e = {e["name"] for e in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for e in M["per_layer"]:
        assert e["moves"] in e2e and set(e["workloads"]) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_resolves_to_its_files(cell):
    files = mf.resolve(M, cell)
    assert files["config"]["name"] == files["workload"]["config"]
    assert files["traffic"]["name"] == files["workload"]["traffic"]
    assert set(files["limits"]["limits"]) == set(NUMBERS)
    assert files["limits"]["tie"] > 0
    assert files["per_layer"], "every cell reports a per-layer metric"
    for m in files["per_layer"]:
        assert callable(mf.load_metric(m["name"]).read)


def _digests(bench):
    return {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in bench.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_is_found_from_new_files_alone(tmp_path):
    before = _digests(BENCH)
    bench = add_tiny_cell(tmp_path)
    copied = {k: v for k, v in _digests(bench).items() if k in before}
    assert all(before[k] == v for k, v in copied.items())
    files = mf.resolve(mf.load_manifest(tmp_path), "tiny", bench)
    assert files["traffic"]["settings"]["num_envs"] == 8
    assert files["config"]["name"] == "tiny"
