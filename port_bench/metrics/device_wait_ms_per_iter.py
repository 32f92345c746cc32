"""device_wait_ms_per_iter (layer: device): the Trainer's span
``device_wait`` over the window (every wait of the loop's thread for
device work: the actions' copy in the default loop, the fetch and the
settle window pipelined), per iteration: the host's slack, near 0 where
the launches set the pace. Nothing to read where the Trainer has no such
span."""


def read(run):
    wait = run.window["timer"].get("device_wait")
    if wait is None or not run.window["iterations"]:
        return None
    return 1e3 * wait / run.window["iterations"]
