"""The port's spans (rainbow_tpu_torch.utils.logging.span and Timer): the
host-clock totals, on any thread; the ``rainbow.<name>`` ranges of a
running torch.profiler; and the Trainer's keys and ranges, on the CPU with
the fake env."""
import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rainbow_tpu_torch import cli
from rainbow_tpu_torch.utils import logging as lg

TINY = ["--num-envs", "4", "--memory-capacity", "1024", "--batch-size", "16",
        "--learn-start", "64", "--replay-frequency", "4", "--target-update",
        "128", "--evaluation-episodes", "2", "--evaluation-size", "20",
        "--hidden-size", "32", "--multi-step", "3", "--env-backend", "fake",
        "--max-episode-length", "400", "--architecture", "data-efficient"]
NEW_KEYS = ("engine", "upload", "launch", "device_wait")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the Trainer runs here are chains of tiny ops,
    which several test workers sharing the cores would otherwise slow by
    thread contention; the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Clock:
    """A perf_counter that reads 0, 1, 2, ... on each thread of its own:
    every span then lasts exactly one second per clock read between its
    start and its end."""

    def __init__(self):
        self._local = threading.local()

    def perf_counter(self):
        n = getattr(self._local, "n", 0)
        self._local.n = n + 1
        return float(n)


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(lg, "time", c)
    return c


@pytest.mark.parametrize("case", ["once", "exception", "nested"])
def test_span_adds_to_totals_once(case, clock):
    timer = lg.Timer()  # made at clock read 0
    if case == "once":
        with timer.span("a"):  # reads 1, 2
            pass
        assert timer.totals == {"a": 1.0}
    elif case == "exception":
        with pytest.raises(ValueError):
            with timer.span("a"):
                raise ValueError("inside")
        assert timer.totals == {"a": 1.0}
    else:
        with timer.span("outer"):  # reads 1 .. 6
            with timer.span("inner"):  # reads 2, 3
                pass
            with timer.span("inner"):  # reads 4, 5
                pass
        assert timer.totals == {"outer": 5.0, "inner": 2.0}
        with lg.span("no_timer"):  # a span without a timer adds nowhere
            pass
        assert set(timer.totals) == {"outer", "inner"}


def test_summary_gives_shares_of_the_wall_time(clock):
    timer = lg.Timer()  # read 0
    with timer.span("outer"):  # reads 1, 4
        with timer.span("inner"):  # reads 2, 3
            pass
    # summary reads 5: outer 3 s and inner 1 s of 5 s since the Timer
    assert timer.summary() == "inner=1.0s(20%) outer=3.0s(60%)"


def test_threads_lose_no_add(clock):
    """More threads than cores, each adding to its own key and to one
    shared key through spans and through ``add``, with a short switch
    interval: every add arrives."""
    timer = lg.Timer()
    threads, reps = 2 * (os.cpu_count() or 4), 400
    start = threading.Barrier(threads)

    def work(k):
        start.wait()
        for _ in range(reps):
            with timer.span("shared"), timer.span(f"own{k}"):
                timer.add("added", 1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,))
              for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    # a span of shared lasts 3 reads of its thread's clock, own{k}'s 1
    assert timer.totals["shared"] == 3.0 * threads * reps
    assert timer.totals["added"] == float(threads * reps)
    for k in range(threads):
        assert timer.totals[f"own{k}"] == float(reps)


def _ranges(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len(lg.RANGE_PREFIX):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"])) for e in events
            if e.get("ph") == "X"
            and e.get("name", "").startswith(lg.RANGE_PREFIX)]


@pytest.mark.parametrize("profiled", [True, False])
def test_ranges_only_under_a_profiler(profiled, tmp_path, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    timer = lg.Timer()

    def spans():
        with timer.span("outer"):
            with lg.span("inner"):
                torch.ones(4).add_(1)

    if not profiled:
        spans()
        assert opened == [] and set(timer.totals) == {"outer"}
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans()
    assert opened == ["rainbow.outer", "rainbow.inner"]
    got = {n: (a, b) for n, a, b in _ranges(prof, tmp_path)}
    assert set(got) == {"outer", "inner"}
    assert got["outer"][0] <= got["inner"][0] <= got["inner"][1] \
        <= got["outer"][1]
    assert set(timer.totals) == {"outer"}


@pytest.mark.parametrize("pipelined", [False, True])
def test_trainer_has_the_new_keys(pipelined, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    side = ["--pipeline-actor"] if pipelined else []
    tr = cli.main(TINY + side + ["--T-max", "192", "--id", "keys"],
                  device="cpu")
    t = tr.timer.totals
    assert all(t.get(k, 0.0) > 0.0 for k in NEW_KEYS), t
    if pipelined:
        # the worker's engine step and upload, the fetch and settle spans
        assert {"fetch", "settle"} <= set(t)
        return
    # nested: within rounding of the sums
    assert t["engine"] + t["upload"] <= t["env"] * (1 + 1e-9), t
    assert t["launch"] + t["device_wait"] <= t["actor"] * (1 + 1e-9), t
    assert not {"fetch", "settle"} & set(t)


@pytest.mark.parametrize("pipelined", [False, True])
def test_cli_profile_holds_the_ranges(pipelined, tmp_path, monkeypatch):
    """--profile's trace of iterations 20-40 (learning from iteration 16)
    holds the Trainer's and the learner round's ranges; pipelined, the
    worker's engine step and upload lie on another thread than the
    launch."""
    monkeypatch.chdir(tmp_path)
    side = ["--pipeline-actor"] if pipelined else []
    cli.main(TINY + side + ["--T-max", "200", "--profile", "--id", "prof"],
             device="cpu")
    path = tmp_path / "results" / "prof" / "trace" / "trace.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tids = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(lg.RANGE_PREFIX):
            tids.setdefault(name, set()).add(e.get("tid"))
    want = {"rainbow." + k for k in NEW_KEYS + (
        "update", "sample", "target", "write_back", "append", "act")}
    assert want <= set(tids), sorted(tids)
    if pipelined:
        assert tids["rainbow.engine"] == tids["rainbow.upload"]
        assert not tids["rainbow.engine"] & tids["rainbow.launch"]
