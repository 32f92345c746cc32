"""roofline_pct.torso (layer: learner round): the torso's convolutions
against their bound over the traced window: the sum of each torso
forward's bound (port_bench/bounds/torso.py: 2·macs·rows operations, three
times that for a forward that autograd records, at the compute dtype's
peak) over the device time of cuDNN's convolution kernels, their layout
conversions and PyTorch's max-pool kernels, by kernel name. The forwards
are tallied at models/dqn.py's ``torso``, which every forward calls, by
(architecture, rows, dtype, whether autograd records it). The torso's
bias, ReLU and residual adds run in PyTorch's generic elementwise kernels,
which cannot be told apart by name, and are not counted."""
import re

import torch

from port_bench.bounds.torso import call_bound_s

PATTERN = re.compile(
    r"conv|fprop|dgrad|wgrad|implicit_gemm|implicit_convolve|cudnn|"
    r"winograd|fft2d|flip_filter|gemm_cf32cf32|nchwToNhwc|nhwcToNchw|"
    r"max_pool", re.IGNORECASE)
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _key(params, cfg, x):
    recorded = (torch.is_grad_enabled()
                and next(iter(params.values())).requires_grad)
    return (cfg.architecture, x.shape[0], DTYPES[x.dtype], recorded)


TALLY = (("rainbow_tpu_torch.models.dqn", "torso", _key),)


def read(run):
    t, calls = run.trace, run.tallies.get("roofline_pct.torso")
    if not t or not calls:
        return None
    busy = sum(s for n, _t, s in t["ops"] if PATTERN.search(n))
    if not busy:
        return None
    h = run.hyper
    bound = sum(c * call_bound_s(arch, h.history, h.frame, rows, dt, rec)
                for (arch, rows, dt, rec), c in calls.items())
    return 100.0 * bound / busy
