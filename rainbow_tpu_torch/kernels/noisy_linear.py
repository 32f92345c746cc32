"""Launch wrapper of the noisy-linear forward kernel (csrc/noisy_linear.cu).

Its plain version is models/noisy.py::noisy_linear_plain.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from rainbow_tpu_torch.kernels import (LAUNCHES, build, check_cuda,
                                       check_dtype, check_shape)

NAME = "noisy_linear_fwd"
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    lib = build.load("noisy_linear")
    fn = lib.noisy_linear_fwd
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def noisy_linear_fwd(params: dict, x: torch.Tensor,
                     eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     relu: bool = False) -> torch.Tensor:
    """y (B, out) in x's dtype; see models/noisy.py::noisy_linear."""
    w_mu, w_sig = params["weight_mu"], params["weight_sigma"]
    b_mu, b_sig = params["bias_mu"], params["bias_sigma"]
    check_cuda(NAME, x=x, weight_mu=w_mu, weight_sigma=w_sig, bias_mu=b_mu,
               bias_sigma=b_sig)
    check_dtype(NAME, "x", x, torch.float32, torch.bfloat16)
    if x.dim() != 2:
        raise ValueError(f"{NAME}: x must be (B, in), got {tuple(x.shape)}")
    b, n_in = x.shape
    n_out = w_mu.shape[0]
    for arg, t, shape in (("weight_mu", w_mu, (n_out, n_in)),
                          ("weight_sigma", w_sig, (n_out, n_in)),
                          ("bias_mu", b_mu, (n_out,)),
                          ("bias_sigma", b_sig, (n_out,))):
        check_dtype(NAME, arg, t, torch.float32)
        check_shape(NAME, arg, t, shape)
    eps_mode, e_in, e_out = 0, None, None
    if eps is not None:
        e_in, e_out = eps
        check_cuda(NAME, eps_in=e_in, eps_out=e_out)
        check_dtype(NAME, "eps_in", e_in, torch.float32)
        check_dtype(NAME, "eps_out", e_out, torch.float32)
        eps_mode = 2 if e_in.dim() == 2 else 1
        lead = (b,) if eps_mode == 2 else ()
        check_shape(NAME, "eps_in", e_in, lead + (n_in,))
        check_shape(NAME, "eps_out", e_out, lead + (n_out,))
    y = torch.empty((b, n_out), dtype=x.dtype, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16), w_mu.data_ptr(),
                 w_sig.data_ptr(), b_mu.data_ptr(), b_sig.data_ptr(),
                 ptr(e_in), ptr(e_out), eps_mode, y.data_ptr(), b, n_in,
                 n_out, int(relu), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    LAUNCHES[NAME] += 1
    return y
