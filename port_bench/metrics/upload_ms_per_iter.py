"""upload_ms_per_iter (layer: engine and upload): the Trainer's span
``upload`` over the window (the packing of the engine's step on the host
and its copies to the device: inside ``env`` in the default loop, on the
pipelined worker's thread otherwise), per iteration. Nothing to read where
the Trainer has no such span."""


def read(run):
    upload = run.window["timer"].get("upload")
    if upload is None or not run.window["iterations"]:
        return None
    return 1e3 * upload / run.window["iterations"]
