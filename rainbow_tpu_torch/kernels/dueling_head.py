"""Launch wrapper of the dueling C51 head epilogue (KB, csrc/head.cu).

Replaces what XLA fuses for the JAX package at rainbow_tpu/models/dqn.py:
148-154 (dueling combine q = v + a − mean_a(a) in the streams' dtype, fp32
(log-)softmax over the atoms) and rainbow_tpu/agent.py:99-102, 122-123
(Σ z·p, argmax, max); with the noisy-linear kernel it does the forward
work of the deleted Pallas kernel fused_dueling_head. Its plain version is
ops/head.py::dueling_head_plain.

Bound on the H100 (A = 6, 51 atoms): the act's B = 1024 moves about 1.5 MB
(v, a, q, argmax, max q) and the learner's B = 32 46 KB, so both are bound
by launch latency; the round's target at B = 8192 also writes the
(B, A, 51) distribution, 21.7 MB in all, 6.5 µs at 3.35 TB/s, bound by
bytes. The kernel runs one warp per row, 4 rows a block, lanes over the
atoms (at most MAX_ATOMS), and takes six actions at a time through the
reductions, with exp from the MUFU (csrc/head.cu's header has the
details). Nothing but the outputs asked for is written: acting asks for
the greedy action and q only.

The CUDA source is built at first use (build.py) and called through ctypes
on the current stream; a nonzero CUDA error from the launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch)

NAME = "dueling_head"
MAX_ATOMS = 128
_MODES = {None: 0, "probs": 1, "log": 2}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("head").dueling_head
    fn.argtypes = [_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def check_atoms(name: str, atoms: int) -> None:
    if not 1 <= atoms <= MAX_ATOMS:
        raise ValueError(f"{name}: atoms must be in [1, {MAX_ATOMS}], got "
                         f"{atoms}")


def dueling_head_fwd(v: torch.Tensor, a: torch.Tensor, support: torch.Tensor,
                     action_space: int, dist: Optional[str] = None):
    """(dist or None, q (B, A), action (B,) int64, max q (B,)); see
    ops/head.py::dueling_head."""
    check_atoms(NAME, support.shape[0])
    if dist not in _MODES:
        raise ValueError(f"{NAME}: dist must be one of {tuple(_MODES)}, got "
                         f"{dist!r}")
    check_cuda(NAME, v=v, a=a, support=support)
    check_dtype(NAME, "v", v, torch.float32, torch.bfloat16)
    check_dtype(NAME, "a", a, v.dtype)
    check_dtype(NAME, "support", support, torch.float32)
    atoms = support.shape[0]
    b = v.shape[0]
    check_shape(NAME, "v", v, (b, atoms))
    check_shape(NAME, "a", a, (b, action_space * atoms))
    if b < 1 or action_space < 1:
        raise ValueError(f"{NAME}: empty batch or action space ({b}, "
                         f"{action_space})")
    dev = v.device
    q = torch.empty((b, action_space), dtype=torch.float32, device=dev)
    act = torch.empty((b,), dtype=torch.int64, device=dev)
    max_q = torch.empty((b,), dtype=torch.float32, device=dev)
    out = (torch.empty((b, action_space, atoms), dtype=torch.float32,
                       device=dev) if dist else None)
    err = _lib()(v.data_ptr(), a.data_ptr(), int(v.dtype == torch.bfloat16),
                 support.data_ptr(), out.data_ptr() if out is not None else 0,
                 _MODES[dist], q.data_ptr(), act.data_ptr(), max_q.data_ptr(),
                 b, action_space, atoms,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
    return out, q, act, max_q
