"""roofline_pct.clip_adam (layer: kernels): the clip + Adam kernel (K9)
over the traced window: the sum of each call's bound from its parameter
count and first moment's width (port_bench/bounds/clip_adam.py) over the
device time of its two launches (the kernels whose names take an
``AdamTable``). The calls are tallied at the wrapper that launches
them."""
from port_bench.bounds.clip_adam import clip_adam
from port_bench.bounds.peaks import bound_s


def _key(params, grads, mu, *rest):
    return (sum(p.numel() for p in params), mu[0].element_size())


TALLY = (("rainbow_tpu_torch.kernels.adam", "clip_adam", _key),)


def read(run):
    t, calls = run.trace, run.tallies.get("roofline_pct.clip_adam")
    if not t or not calls:
        return None
    busy = sum(s for n, _t, s in t["ops"] if "AdamTable" in n)
    if not busy:
        return None
    bound = sum(c * bound_s(*clip_adam(n, mu_bytes), "float32")
                for (n, mu_bytes), c in calls.items())
    return 100.0 * bound / busy
