"""Reading a torch.profiler trace of the traced window: the device's
operations and busy time, the idle gaps and what the host was doing in
each, and the breakdown that a result line carries."""
from __future__ import annotations

import json
import os
import tempfile
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "port_bench.traced_window"
SPAN_PREFIX = "port_bench."


def read_profile(prof) -> dict:
    """The events of a finished profiler, from its Chrome trace (written to
    the run's temporary directory and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def _union(intervals: List[Tuple[float, float]]):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def parse(events: list) -> dict:
    """From Chrome-trace events (µs): the traced window (the span
    ``port_bench.traced_window``), every device operation in it as (name,
    start, seconds), its busy seconds (the union of their intervals), the
    idle gaps with the host span that overlaps each most, and the host
    spans of the harness."""
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW_SPAN]
    if not win:
        raise RuntimeError("the trace holds no traced-window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    ops, iv = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t > s:
            ops.append((e["name"], s, (t - s) / 1e6))
            iv.append((s, t))
    busy = _union(iv)
    spans = [(e["name"][len(SPAN_PREFIX):], float(e["ts"]),
              float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX)
             and e["name"] != WINDOW_SPAN]
    gaps, at = [], w0
    for s, t in busy + [[w1, w1]]:
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    labelled = []
    for s, t in gaps:
        best, most = "outside the harness's spans", 0.0
        for name, a, b in spans:
            ov = min(b, t) - max(a, s)
            if ov > most:
                best, most = name, ov
        labelled.append((best, (t - s) / 1e6))
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(t - s for s, t in busy) / 1e6,
            "ops": ops, "gaps": labelled, "spans": spans}


def breakdown(trace: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing."""
    by_name = {}
    for name, _s, sec in trace["ops"]:
        by_name[name] = by_name.get(name, 0.0) + sec
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace["gaps"], key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}
