"""replay_device_pct (layer: replay): the share of the device's operation
time in the traced window of the replay's kernels: the stratified draw
(K5: tree build and descent), the window gather (K6), the priority
write-back (K7) and the append with the frame stack (KC), by name."""
import re

PATTERN = re.compile(r"tree_build_kernel|descend_kernel|gather_window_kernel|"
                     r"write_priorities_kernel|append_framestack_kernel")


def read(run):
    t = run.trace
    if not t or not t["ops"]:
        return None
    total = sum(s for _n, _t, s in t["ops"])
    replay = sum(s for n, _t, s in t["ops"] if PATTERN.search(n))
    if not replay:
        return None
    return 100.0 * replay / total
