"""On the card, at each cell's own size: the program passes every limit,
and the control (the reference in the precision below the
configuration's, in the program's place) and the planted faults do not.
Marked ``cuda``; each test skips without a card, decided inside it.

    python -m pytest port_bench/tests -q -m cuda
"""
import json

import pytest
import torch

from port_bench.harness import cell, manifest
from port_bench.harness.faults import FAULTS
from port_bench.readings import control_precision
from port_bench.reference.check import NUMBERS
from port_bench.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(name):
    _need_card()
    files = manifest.resolve(manifest.load_manifest(), name)
    limits = files["limits"]["limits"]
    ctrl = control_precision(files["config"])
    for seed in (31, 32, 2147483033):
        got = cell.run_cell(name, seed, None, False, device="cuda",
                            control=ctrl)["readings"]
        assert all(got["program"][n] <= limits[n] for n in NUMBERS), got
        assert any(v > limits[n] for n, v in got["control"].items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["half_batch", "frame_altered",
                                   "leaf_unchanged", "priorities_permuted"])
def test_planted_fault_fails(name, fault, monkeypatch):
    _need_card()
    FAULTS[fault](monkeypatch.setattr)
    limits = manifest.resolve(manifest.load_manifest(),
                              name)["limits"]["limits"]
    got = cell.run_cell(name, 41, None, False, device="cuda")["readings"]
    assert any(got["program"][n] > limits[n] for n in NUMBERS), got
