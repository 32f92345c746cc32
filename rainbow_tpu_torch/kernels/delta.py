"""Launch wrapper of the delta kernel (csrc/delta.cu), K10.

Its plain version is train.py::_apply_delta_plain.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch)

NAME = "apply_delta"
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib():
    fn = build.load("delta").apply_delta
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P, _P]
    fn.restype = _I
    return fn


def apply_delta(stack: torch.Tensor, offsets: torch.Tensor,
                pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """K10: the observations (N, F, F) uint8 of a delta upload: the stack's
    newest plane ``stack[..., -1]`` with ``val`` written at ``pos`` within
    each env's segment [offsets[e], offsets[e + 1]) (see
    train.py::_apply_delta_plain), in one launch on the current stream.
    ``stack`` is uint8 (N, F, F, H), ``offsets`` int32 (N + 1,), the
    exclusive sums of the per-env counts from 0 (train.delta_offsets),
    ``pos`` uint16 and ``val`` uint8 (kp,); entries past offsets[N] are
    dropped."""
    check_cuda(NAME, stack=stack, offsets=offsets, pos=pos, val=val)
    if stack.dim() != 4 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"{NAME}: stack must be (N, F, F, H), got "
                         f"{tuple(stack.shape)}")
    n, f, _, h = stack.shape
    kp = pos.shape[0] if pos.dim() == 1 else -1
    for arg, t, dtype, shape in (("stack", stack, torch.uint8, stack.shape),
                                 ("offsets", offsets, torch.int32, (n + 1,)),
                                 ("pos", pos, torch.uint16, (kp,)),
                                 ("val", val, torch.uint8, (kp,))):
        check_dtype(NAME, arg, t, dtype)
        check_shape(NAME, arg, t, shape)
    if h == 4 and (stack.data_ptr() % 16 or (f * f) % 4):
        raise ValueError(f"{NAME}: a 4-frame stack must be 16-byte aligned "
                         "with a plane of a multiple of 4 pixels")
    obs = torch.empty((n, f, f), dtype=torch.uint8, device=stack.device)
    err = _lib()(stack.data_ptr(), offsets.data_ptr(), pos.data_ptr(),
                 val.data_ptr(), n, f * f, h, kp, obs.data_ptr(),
                 torch.cuda.current_stream(stack.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
    return obs
