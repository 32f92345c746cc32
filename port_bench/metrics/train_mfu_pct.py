"""train_mfu_pct (the whole training step): the model's operations over
the window (port_bench/bounds/model_flops.py: 5 forward-equivalents per
sampled transition and one forward per env-step acted), over the window's
seconds, over the peak of the compute dtype (67 TFLOP/s float32, 989
bfloat16; port_bench/bounds/peaks.py)."""
from port_bench.bounds.model_flops import iteration_flops
from port_bench.bounds.peaks import FLOP_PER_S


def read(run):
    w = run.window
    if not w["iterations"] or not w["seconds"]:
        return None
    flops = iteration_flops(run.hyper, run.actions) * w["iterations"]
    return 100.0 * flops / w["seconds"] / FLOP_PER_S[run.hyper.compute_dtype]
