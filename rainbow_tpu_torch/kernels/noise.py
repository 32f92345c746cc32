"""Launch wrapper of the noise kernel (csrc/noise.cu), K2.

Its plain version is models/noisy.py::philox_noise_plain; the stream both
follow is written down in csrc/noise.cu. A draw is one float32 buffer laid
out by ``noise_layout``; the tensors handed back are views of it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, Sequence, Tuple

import torch

from rainbow_tpu_torch.kernels import build, count_launch

NAME = "scaled_noise"
_P, _LL = ctypes.c_void_p, ctypes.c_longlong


@functools.cache
def _lib():
    lib = build.load("noise")
    lib.scaled_noise.argtypes = [_P, _LL, ctypes.c_ulonglong,
                                 ctypes.c_ulonglong, _P]
    lib.noise_box_muller.argtypes = [_P, _P, _LL, _P]
    for fn in (lib.scaled_noise, lib.noise_box_muller):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=64)
def noise_layout(shapes: Tuple[tuple, ...]) -> Tuple[Tuple[int, ...], int]:
    """(the float offset of each tensor of a draw of ``shapes`` in its
    buffer, the buffer's length in floats). Tensor k takes ceil(n_k / 4)
    Philox counters and starts at 4 × the counters before it, so every
    offset is a multiple of 4 floats (16 bytes) and the length is the
    draw's stream words (models/noisy.py::noise_words)."""
    offsets, at = [], 0
    for shape in shapes:
        offsets.append(at)
        at += 4 * -(-math.prod(shape) // 4)
    return tuple(offsets), at


def _check_cuda(dev: torch.device) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{NAME}: needs a CUDA device, got {dev}")


def scaled_noise(seed: int, offset: int, shapes: Sequence[tuple],
                 device) -> List[torch.Tensor]:
    """K2: one float32 tensor of sign(n)·√|n| per shape in ``shapes``, drawn
    from the stream at (``seed``, ``offset``) on the CUDA ``device``, in one
    launch on its current stream. The tensors are contiguous views of one
    buffer (noise_layout), which lives as long as any of them. The caller
    advances the stream (see models/noisy.py::noise_words)."""
    dev = torch.device(device)
    _check_cuda(dev)
    if not shapes:
        raise ValueError(f"{NAME}: draws at least one tensor")
    if offset % 4 or not 0 <= seed < 2 ** 64 or offset < 0:
        raise ValueError(f"{NAME}: needs a 64-bit seed and an offset that is "
                         f"a multiple of 4, got {seed}, {offset}")
    shapes = tuple(tuple(s) for s in shapes)
    offsets, total = noise_layout(shapes)
    buf = torch.empty(total, dtype=torch.float32, device=dev)
    if buf.data_ptr() % 16:
        raise RuntimeError(f"{NAME}: the buffer is not 16-byte aligned")
    err = _lib().scaled_noise(buf.data_ptr(), total // 4, offset // 4, seed,
                              torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
    return [buf[o:o + math.prod(s)].view(s) for o, s in zip(offsets, shapes)]


def box_muller(words: torch.Tensor) -> torch.Tensor:
    """The kernel's Box–Muller and transform alone, on given words: ``words``
    (..., 2k) int64 in [0, 2^32), read as pairs (a, b), on the card; returns
    (..., 2k) float32, the eps of each pair in its two places. Checks the
    kernel's float32 arithmetic against models/noisy.py::
    scaled_box_muller_plain on chosen words; not on the main path, so it
    counts no launch."""
    _check_cuda(words.device)
    if words.dtype != torch.int64 or words.shape[-1] % 2:
        raise ValueError(f"{NAME}: words must be int64 pairs, got "
                         f"{words.dtype} {tuple(words.shape)}")
    words = words.contiguous()
    out = torch.empty(words.shape, dtype=torch.float32, device=words.device)
    err = _lib().noise_box_muller(
        words.data_ptr(), out.data_ptr(), words.numel() // 2,
        torch.cuda.current_stream(words.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    return out
