"""The readers of the Trainer's spans: each is the span's seconds over the
window per iteration, in ms, and nothing where the Trainer has no such
span (the tree before it had one) or the window no iteration."""
from types import SimpleNamespace

import pytest

from port_bench.harness import manifest as mf

KEYS = {"engine_step_ms_per_iter": "engine", "upload_ms_per_iter": "upload",
        "launch_ms_per_iter": "launch",
        "device_wait_ms_per_iter": "device_wait"}


def _run(timer, iterations):
    return SimpleNamespace(settings={}, window={"timer": timer,
                                                "iterations": iterations})


@pytest.mark.parametrize("name", sorted(KEYS))
def test_reader_reads_its_span(name):
    read = mf.load_metric(name).read
    timer = {"env": 9.0, "actor": 9.0, "engine": 0.5, "upload": 0.25,
             "launch": 2.0, "device_wait": 4.0}
    assert read(_run(timer, 250)) == pytest.approx(
        1e3 * timer[KEYS[name]] / 250, rel=1e-12)
    # the same in the pipelined loop: the settings do not matter
    piped = _run(timer, 250)
    piped.settings["pipeline_actor"] = True
    assert read(piped) == read(_run(timer, 250))


@pytest.mark.parametrize("name", sorted(KEYS))
def test_reader_reads_nothing_without_its_span(name):
    read = mf.load_metric(name).read
    old = {"env": 9.0, "actor": 9.0, "fetch": 1.0, "settle": 1.0}
    assert read(_run(old, 250)) is None
    assert read(_run({KEYS[name]: 1.0}, 0)) is None


def test_every_cell_reads_the_four():
    m = mf.load_manifest()
    for cell in (w["name"] for w in m["workloads"]):
        names = {e["name"] for e in mf.resolve(m, cell)["per_layer"]}
        assert set(KEYS) <= names, cell
    for e in m["per_layer"]:
        if e["name"] in KEYS:
            assert e["source"] == "program_span" and e["unit"] == "ms"
