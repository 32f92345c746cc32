"""The comparison that decides ``correct``, driven on the CPU through the
whole of a run of the tiny cell (the harness's look for a card skipped,
the program's plain versions in place of its kernels): a sound run is
correct, and each fault that a one-chip training cell can have, planted
underneath, comes out not correct."""
import json

import pytest
import torch

from port_bench.harness import cell
from port_bench.harness.faults import FAULTS
from port_bench.reference.rainbow import Precision


def _run(bench, seed):
    torch.set_num_threads(2)
    return cell.run_cell("tiny", seed, 0.5, False, device="cpu", bench=bench)


def test_sound_run_is_correct(tiny_bench):
    out = _run(tiny_bench, 21)
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["attempted"] > 0


@pytest.mark.parametrize("fault,number", [
    ("unchanged", "mu"), ("half_batch", "mu"),
    ("leaf_unchanged", "change_worst"), ("priorities_permuted", "priorities"),
    ("action_altered", "act"), ("frame_altered", "append")])
def test_fault_is_not_correct(tiny_bench, monkeypatch, fault, number):
    FAULTS[fault](monkeypatch.setattr)
    out = _run(tiny_bench, 22)
    assert not out["result"]["correct"]
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_control_is_not_correct(tiny_bench):
    """The reference in TF32, the precision below the configuration's, in
    the program's place, fails a limit; the program passes them all."""
    torch.set_num_threads(2)
    out = cell.run_cell("tiny", 24, None, False, device="cpu",
                        bench=tiny_bench,
                        control=Precision(torch.float32, "tf32"))
    limits = json.loads((tiny_bench / "limits" / "tiny.json").read_text())
    got = out["readings"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert any(v > limits["limits"][n] for n, v in got["control"].items())
