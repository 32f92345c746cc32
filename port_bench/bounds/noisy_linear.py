"""Operations and bytes of the noisy-linear kernel (KA), forward and
backward, from its shapes: ``b`` rows, ``n_in`` -> ``n_out``, noise
``mode`` "mu" (none), "shared" (one ε_in, ε_out) or "row" (one per row),
the activations in ``dtype`` and the parameters, their gradients and the
noise in float32. Each input byte is read once and each output byte
written once; the forward reads μ_W and σ_W, the backward reads both and
writes both gradients."""
XBYTES = {"float32": 4, "bfloat16": 2}


def _noise_rows(b: int, mode: str) -> int:
    return {"mu": 0, "shared": 1, "row": b}[mode]


def forward(b: int, n_in: int, n_out: int, mode: str, dtype: str):
    """(operations, bytes) of y = x·μ_Wᵀ + ((x ⊙ ε_in)·σ_Wᵀ) ⊙ ε_out + μ_b
    + σ_b ⊙ ε_out (or x·μ_Wᵀ + μ_b without noise)."""
    xb = XBYTES[dtype]
    if mode == "mu":
        return (2 * b * n_in * n_out + b * n_out,
                xb * b * (n_in + n_out) + 4 * (n_in * n_out + n_out))
    return (4 * b * n_in * n_out + b * n_in + 6 * b * n_out,
            xb * b * (n_in + n_out)
            + 4 * (_noise_rows(b, mode) * (n_in + n_out)
                   + 2 * n_in * n_out + 2 * n_out))


def backward(b: int, n_in: int, n_out: int, mode: str, dtype: str):
    """(operations, bytes) of dx, dμ_W, dσ_W, dμ_b and dσ_b from x, the
    output's gradient g and the noise."""
    xb = XBYTES[dtype]
    if mode == "mu":
        return (4 * b * n_in * n_out + b * n_out,
                xb * 2 * b * (n_in + n_out) + 4 * (2 * n_in * n_out + n_out))
    return (8 * b * n_in * n_out + 3 * b * n_out + 3 * b * n_in,
            xb * 2 * b * (n_in + n_out)
            + 4 * (4 * n_in * n_out + _noise_rows(b, mode) * (n_in + n_out)
                   + 2 * n_out))
