"""device_idle_pct (layer: device): the share of the traced window in
which no operation runs on the device (the union of the intervals of its
kernels, copies and fills, from the profiler's trace)."""


def read(run):
    t = run.trace
    if not t or not t["window_s"] or not t["ops"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
