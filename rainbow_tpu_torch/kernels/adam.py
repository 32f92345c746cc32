"""Launch wrapper of the clip + Adam kernel (csrc/adam.cu).

Its plain version is agent.py::apply_grads_plain.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch)

NAME = "clip_adam"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_TENSORS = 32  # csrc/adam.cu's MAX_TENSORS; checked against the library


class _Table(ctypes.Structure):
    _fields_ = [("p", _P * MAX_TENSORS), ("g", _P * MAX_TENSORS),
                ("mu", _P * MAX_TENSORS), ("nu", _P * MAX_TENSORS),
                ("n", ctypes.c_longlong * MAX_TENSORS),
                ("block_start", _I * (MAX_TENSORS + 1)), ("count", _I)]


@functools.cache
def _lib():
    lib = build.load("adam")
    if lib.adam_max_tensors() != MAX_TENSORS:
        raise RuntimeError(f"{NAME}: table size differs from csrc/adam.cu")
    fn = lib.adam_clip_step
    fn.argtypes = [ctypes.POINTER(_Table), _P, _P, _I, _F, _F, _F, _F, _F,
                   _F, _F, _P]
    fn.restype = _I
    return fn, lib.adam_chunk()


def clip_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
              count: torch.Tensor, lr: float, b1: float, b2: float,
              eps: float, max_norm: float) -> None:
    """One global-norm clip + Adam step, in place on ``params``, ``mu``,
    ``nu`` and Adam's int32 ``count``, in one call: two launches on the
    current stream. ``params``, ``grads`` and ``nu`` are float32, ``mu``
    float32 or bfloat16 (the same for all tensors), each list in the same
    order. See agent.py::apply_grads_plain."""
    n = len(params)
    if not 0 < n <= MAX_TENSORS or not len(grads) == len(mu) == len(nu) == n:
        raise ValueError(f"{NAME}: needs 1 to {MAX_TENSORS} tensors, the same "
                         f"number of each kind; got {len(params)} params, "
                         f"{len(grads)} grads, {len(mu)} mu, {len(nu)} nu")
    check_cuda(NAME, count=count)
    check_dtype(NAME, "count", count, torch.int32)
    check_shape(NAME, "count", count, ())
    mu_dtype = mu[0].dtype
    fn, chunk = _lib()
    table = _Table()
    blocks = 0
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        check_cuda(NAME, param=p, grad=g, mu=m, nu=v)
        for arg, t, dtypes in (("param", p, (torch.float32,)),
                               ("grad", g, (torch.float32,)),
                               ("mu", m, (mu_dtype,)),
                               ("nu", v, (torch.float32,))):
            check_dtype(NAME, f"{arg} {i}", t, *dtypes)
            check_shape(NAME, f"{arg} {i}", t, p.shape)
        table.p[i], table.g[i] = p.data_ptr(), g.data_ptr()
        table.mu[i], table.nu[i] = m.data_ptr(), v.data_ptr()
        table.n[i] = p.numel()
        table.block_start[i] = blocks
        blocks += -(-p.numel() // chunk)
    check_dtype(NAME, "mu", mu[0], torch.float32, torch.bfloat16)
    table.block_start[n] = blocks
    table.count = n
    partials = torch.empty((blocks,), dtype=torch.float32,
                           device=count.device)
    err = fn(ctypes.byref(table), partials.data_ptr(), count.data_ptr(),
             int(mu_dtype == torch.bfloat16), lr, b1, b2, 1.0 - b1, 1.0 - b2,
             eps, max_norm, torch.cuda.current_stream(count.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
