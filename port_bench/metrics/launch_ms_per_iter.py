"""launch_ms_per_iter (layer: schedule): the Trainer's span ``launch``
over the window (the host's enqueue of one iteration, ``Trainer._launch``:
the wait for the worker's upload event, the delta kernel, the learner
round, the append and the act), per iteration. Nothing to read where the
Trainer has no such span."""


def read(run):
    launch = run.window["timer"].get("launch")
    if launch is None or not run.window["iterations"]:
        return None
    return 1e3 * launch / run.window["iterations"]
