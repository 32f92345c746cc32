"""torso_device_pct (layer: learner round): the convolution kernels'
share of the device's operation time in the traced window: the forward
and both backward convolutions of models/dqn.py's torso, which cuDNN runs
(implicit GEMMs, FFT and Winograd algorithms and their complex GEMMs),
with cuDNN's layout changes and conversions around them, by kernel name.
The torso's bias, ReLU and casts run in PyTorch's generic elementwise
kernels and are not counted."""
import re

PATTERN = re.compile(
    r"conv|fprop|dgrad|wgrad|implicit_gemm|implicit_convolve|cudnn|"
    r"winograd|fft2d|flip_filter|gemm_cf32cf32|nchwToNhwc|nhwcToNchw",
    re.IGNORECASE)


def read(run):
    t = run.trace
    if not t or not t["ops"]:
        return None
    total = sum(s for _n, _t, s in t["ops"])
    conv = sum(s for n, _t, s in t["ops"] if PATTERN.search(n))
    if not conv:
        return None
    return 100.0 * conv / total
