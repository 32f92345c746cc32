"""Operations and bytes of the global-norm clip + Adam kernel (K9) over
``n`` parameters: params, gradients, μ and ν read once, params, μ and ν
written once, μ in ``mu_bytes`` a value; about 20 operations a
parameter."""


def clip_adam(n: int, mu_bytes: int):
    return 20 * n, 4 * n * 5 + 2 * n * mu_bytes
