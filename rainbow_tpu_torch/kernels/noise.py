"""Launch wrapper of the noise kernel (csrc/noise.cu), K2.

Its plain version is models/noisy.py::philox_noise_plain; the stream both
follow is written down in csrc/noise.cu.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence

import torch

from rainbow_tpu_torch.kernels import build, count_launch

NAME = "scaled_noise"
MAX_TENSORS = 16  # csrc/noise.cu's MAX_TENSORS; checked against the library
_LL = ctypes.c_longlong


class _Table(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p * MAX_TENSORS),
                ("n", _LL * MAX_TENSORS), ("base", _LL * MAX_TENSORS),
                ("thread_start", _LL * (MAX_TENSORS + 1)),
                ("count", ctypes.c_int)]


@functools.cache
def _lib():
    lib = build.load("noise")
    if lib.noise_max_tensors() != MAX_TENSORS:
        raise RuntimeError(f"{NAME}: table size differs from csrc/noise.cu")
    fn = lib.scaled_noise
    fn.argtypes = [ctypes.POINTER(_Table), ctypes.c_ulonglong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def scaled_noise(seed: int, offset: int, shapes: Sequence[tuple],
                 device) -> List[torch.Tensor]:
    """K2: one float32 tensor of sign(n)·√|n| per shape in ``shapes``, drawn
    from the stream at (``seed``, ``offset``) on the CUDA ``device``, in one
    launch on its current stream. The caller advances the stream (see
    models/noisy.py::noise_words)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: needs a CUDA device, got {dev}")
    if not 0 < len(shapes) <= MAX_TENSORS:
        raise ValueError(f"{NAME}: draws 1 to {MAX_TENSORS} tensors, got "
                         f"{len(shapes)}")
    if offset % 4 or not 0 <= seed < 2 ** 64 or offset < 0:
        raise ValueError(f"{NAME}: needs a 64-bit seed and an offset that is "
                         f"a multiple of 4, got {seed}, {offset}")
    fn = _lib()
    table = _Table()
    outs = []
    base, threads = offset // 4, 0
    for k, shape in enumerate(shapes):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        if out.data_ptr() % 16:
            raise RuntimeError(f"{NAME}: output {k} is not 16-byte aligned")
        m = -(-out.numel() // 4)
        table.out[k], table.n[k] = out.data_ptr(), out.numel()
        table.base[k], table.thread_start[k] = base, threads
        base, threads = base + m, threads + m
        outs.append(out)
    table.thread_start[len(shapes)] = threads
    table.count = len(shapes)
    err = fn(ctypes.byref(table), seed,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
    return outs
