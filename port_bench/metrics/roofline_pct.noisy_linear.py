"""roofline_pct.noisy_linear (layer: kernels): the noisy-linear kernel
(KA) over the traced window: the sum of each launch's bound, worked out
from its shapes (port_bench/bounds/noisy_linear.py at the peaks of
port_bench/bounds/peaks.py), over the sum of the device time of every
kernel whose name holds ``noisy_linear`` (its forward, backward and
split-K reductions). The launches and their shapes are tallied at the
wrapper that launches them."""
from port_bench.bounds import noisy_linear as ka
from port_bench.bounds.peaks import bound_s

DTYPES = {"torch.float32": "float32", "torch.bfloat16": "bfloat16"}


def _mode(eps):
    if eps is None:
        return "mu"
    return "row" if eps[0].dim() == 2 else "shared"


def _fwd_key(params, x, eps=None, relu=False):
    return ("fwd", x.shape[0], x.shape[1], params["weight_mu"].shape[0],
            _mode(eps), DTYPES[str(x.dtype)])


def _bwd_key(w_mu, w_sig, x, g, eps=None, y=None):
    return ("bwd", x.shape[0], x.shape[1], w_mu.shape[0], _mode(eps),
            DTYPES[str(x.dtype)])


TALLY = (("rainbow_tpu_torch.kernels.noisy_linear", "noisy_linear_fwd",
          _fwd_key),
         ("rainbow_tpu_torch.kernels.noisy_linear", "noisy_linear_bwd",
          _bwd_key))


def read(run):
    t, calls = run.trace, run.tallies.get("roofline_pct.noisy_linear")
    if not t or not calls:
        return None
    busy = sum(s for n, _t, s in t["ops"] if "noisy_linear" in n)
    if not busy:
        return None
    bound = 0.0
    for (kind, b, n_in, n_out, mode, dt), count in calls.items():
        fn = ka.forward if kind == "fwd" else ka.backward
        bound += count * bound_s(*fn(b, n_in, n_out, mode, dt), dt)
    return 100.0 * bound / busy
