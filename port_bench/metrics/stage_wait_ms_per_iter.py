"""stage_wait_ms_per_iter (layer: pipeline): in the pipelined loop the
Trainer's timer ``env`` times the wait for the worker's staged step
(``fut.result()``), per iteration of the window. Nothing to read in the
default loop."""


def read(run):
    if not run.settings.get("pipeline_actor"):
        return None
    env = run.window["timer"].get("env")
    if env is None or not run.window["iterations"]:
        return None
    return 1e3 * env / run.window["iterations"]
