"""engine_step_ms_per_iter (layer: engine and upload): the Trainer's span
``engine`` over the window (the engine's step alone: inside ``env`` in the
default loop, on the pipelined worker's thread otherwise), per iteration.
Nothing to read where the Trainer has no such span."""


def read(run):
    engine = run.window["timer"].get("engine")
    if engine is None or not run.window["iterations"]:
        return None
    return 1e3 * engine / run.window["iterations"]
