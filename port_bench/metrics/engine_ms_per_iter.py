"""engine_ms_per_iter (layer: engine and upload): the Trainer's own timer
``env`` over the window (the engine step, the packing of its output and
the upload: ``Trainer._stage``, serial with the device in the default
loop), per iteration. Nothing to read in the pipelined loop, where the
same timer is the wait for the worker."""


def read(run):
    if run.settings.get("pipeline_actor"):
        return None
    env = run.window["timer"].get("env")
    if env is None or not run.window["iterations"]:
        return None
    return 1e3 * env / run.window["iterations"]
