"""Launch wrapper of the clip + Adam kernel (csrc/adam.cu).

Its plain version is agent.py::apply_grads_plain.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch,
                                       device_buffer)

NAME = "clip_adam"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
MAX_TENSORS = 64  # csrc/adam.cu's MAX_TENSORS (the IMPALA ResNet x4 has
                  # 46 tensors); checked against the library
THREADS = 256     # csrc/adam.cu: threads a block of either pass
SUM_CHUNK = 4096  # csrc/adam.cu: pass 1's elements a block (16 a thread)
UPDATE_CHUNK = 1024  # csrc/adam.cu: pass 2's (4 a thread)
KEEP_G_MAX = 1 << 22  # grads the L2 keeps between the passes: 16 MB, a
                      # third of the H100's 50 MB L2
# csrc/adam.cu's AdamTable::vec bits: the arrays accessed four elements at
# a time, in the order (p, g, mu, nu).
VEC_BITS = (1, 2, 4, 8)


class _Table(ctypes.Structure):
    _fields_ = [("p", _P * MAX_TENSORS), ("g", _P * MAX_TENSORS),
                ("mu", _P * MAX_TENSORS), ("nu", _P * MAX_TENSORS),
                ("n", ctypes.c_longlong * MAX_TENSORS),
                ("sum_start", _I * (MAX_TENSORS + 1)),
                ("update_start", _I * (MAX_TENSORS + 1)),
                ("vec", ctypes.c_ubyte * MAX_TENSORS), ("count", _I)]


@dataclasses.dataclass(frozen=True)
class AdamPlan:
    """K9's plan for a list of tensors: ``sum_start`` pass 1's first chunk
    of each tensor (chunks of SUM_CHUNK elements) and the total last,
    ``update_start`` the same for pass 2's chunks of UPDATE_CHUNK, and per
    tensor ``vec``, the VEC_BITS of the arrays whose pointers allow four
    elements a step (16 bytes; 8 for a bf16 mu); ``keep_g`` whether pass
    1 asks L2 to keep g's lines for pass 2 (at most KEEP_G_MAX elements in
    all)."""
    sum_start: tuple
    update_start: tuple
    vec: tuple
    keep_g: bool


def adam_plan(numels: Sequence[int], pointers: Sequence[tuple],
              mu_bytes: int) -> AdamPlan:
    """K9's plan for tensors of ``numels`` elements whose arrays lie at
    ``pointers`` (per tensor the addresses of p, g, mu and nu), with a mu
    of ``mu_bytes`` a value (4 float32, 2 bf16); csrc/adam.cu checks it."""
    starts = {size: [0] for size in (SUM_CHUNK, UPDATE_CHUNK)}
    for n in numels:
        for size, start in starts.items():
            start.append(start[-1] - (-n // size))
    aligns = (16, 16, 4 * mu_bytes, 16)
    vec = tuple(sum(bit for bit, ptr, a in zip(VEC_BITS, ptrs, aligns)
                    if ptr % a == 0) for ptrs in pointers)
    return AdamPlan(tuple(starts[SUM_CHUNK]), tuple(starts[UPDATE_CHUNK]),
                    vec, sum(numels) <= KEEP_G_MAX)


@functools.cache
def _lib():
    lib = build.load("adam")
    if (lib.adam_max_tensors(), lib.adam_chunk(), lib.adam_update_chunk(),
            lib.adam_threads()) != (MAX_TENSORS, SUM_CHUNK, UPDATE_CHUNK,
                                    THREADS):
        raise RuntimeError(f"{NAME}: table or chunks differ from "
                           "csrc/adam.cu")
    fn = lib.adam_clip_step
    fn.argtypes = [ctypes.POINTER(_Table), _P, _P, _P, _I, _I] + [_F] * 7 \
        + [_P]
    fn.restype = _I
    return fn


def clip_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
              count: torch.Tensor, lr: float, b1: float, b2: float,
              eps: float, max_norm: float) -> None:
    """One global-norm clip + Adam step, in place on ``params``, ``mu``,
    ``nu`` and Adam's int32 ``count``, in one call: two launches on the
    current stream under adam_plan. ``params``, ``grads`` and ``nu`` are
    float32, ``mu`` float32 or bfloat16 (the same for all tensors), each
    list in the same order; any of them may be views at any offset. The
    partials and the norm are per call; the last block's ticket lives in
    the current stream's buffer (kernels.device_buffer), so calls on one
    stream run one at a time. See agent.py::apply_grads_plain."""
    n = len(params)
    if not 0 < n <= MAX_TENSORS or not len(grads) == len(mu) == len(nu) == n:
        raise ValueError(f"{NAME}: needs 1 to {MAX_TENSORS} tensors, the same "
                         f"number of each kind; got {len(params)} params, "
                         f"{len(grads)} grads, {len(mu)} mu, {len(nu)} nu")
    check_cuda(NAME, count=count)
    check_dtype(NAME, "count", count, torch.int32)
    check_shape(NAME, "count", count, ())
    mu_dtype = mu[0].dtype
    check_dtype(NAME, "mu", mu[0], torch.float32, torch.bfloat16)
    for i, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        check_cuda(NAME, param=p, grad=g, mu=m, nu=v)
        for arg, t, dtype in (("param", p, torch.float32),
                              ("grad", g, torch.float32),
                              ("mu", m, mu_dtype), ("nu", v, torch.float32)):
            check_dtype(NAME, f"{arg} {i}", t, dtype)
            check_shape(NAME, f"{arg} {i}", t, p.shape)
    pointers = [tuple(t.data_ptr() for t in ts)
                for ts in zip(params, grads, mu, nu)]
    plan = adam_plan([p.numel() for p in params], pointers,
                     mu[0].element_size())
    fn = _lib()
    table = _Table()
    for i, (p, ptrs) in enumerate(zip(params, pointers)):
        table.p[i], table.g[i], table.mu[i], table.nu[i] = ptrs
        table.n[i] = p.numel()
        table.vec[i] = plan.vec[i]
    for i in range(n + 1):
        table.sum_start[i] = plan.sum_start[i]
        table.update_start[i] = plan.update_start[i]
    table.count = n
    dev = count.device
    scratch = torch.empty((plan.sum_start[-1] + 1,), dtype=torch.float32,
                          device=dev)
    ticket = device_buffer(NAME + " ticket", dev, 1, torch.int32)
    err = fn(ctypes.byref(table), scratch.data_ptr(), ticket.data_ptr(),
             count.data_ptr(), int(mu_dtype == torch.bfloat16),
             int(plan.keep_g), lr, b1, b2,
             1.0 - b1, 1.0 - b2, eps, max_norm,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
