"""Hand-written Hopper kernels of the actor and the learner, and their launch
wrappers.

  noisy_linear_fwd   CUDA C++  csrc/noisy_linear.cu       (models/noisy.py)
  noisy_linear_bwd   CUDA C++  csrc/noisy_linear.cu       (models/noisy.py)
  dueling_head       CUDA C++  csrc/head.cu               (ops/head.py)
  c51_target         CUDA C++  csrc/head.cu               (ops/c51.py)
  head_loss          CUDA C++  csrc/head.cu               (ops/c51.py)
  append_framestack  CUDA C++  csrc/append_framestack.cu  (ops/preprocess.py)
  clip_adam          CUDA C++  csrc/adam.cu               (agent.py)
  stratified_sample  CUDA C++  csrc/replay.cu             (replay/prioritized.py)
  gather_window      CUDA C++  csrc/replay.cu             (replay/prioritized.py)
  write_priorities   CUDA C++  csrc/replay.cu             (replay/prioritized.py)
  scaled_noise       CUDA C++  csrc/noise.cu              (models/noisy.py)
  apply_delta        CUDA C++  csrc/delta.cu              (train.py)

The CUDA sources are compiled with nvcc for sm_90a into shared libraries
under ``rainbow_tpu_torch/_build/`` at first use (build.py) and called
through ctypes. Each wrapper takes CUDA tensors only, checks them, launches, raises
on a launch error and adds one to ``LAUNCHES[name]`` (``count_launch``,
under a lock: an asynchronous evaluation launches from a second thread).
A kernel's scratch and tickets that outlive a call come from
``device_buffer``: one per stream, allocated at the stream's first call,
outside any CUDA graph capture, and kept. The plain PyTorch version of each
kernel sits beside its caller and runs only on CPU tensors.
"""
from __future__ import annotations

import threading

import torch

# noisy_linear_bwd_large counts the noisy_linear_bwd launches that took the
# large-batch path; every other name counts its wrapper's launches.
LAUNCHES = {"noisy_linear_fwd": 0, "noisy_linear_bwd": 0,
            "noisy_linear_bwd_large": 0, "dueling_head": 0,
            "c51_target": 0, "head_loss": 0, "append_framestack": 0,
            "clip_adam": 0, "stratified_sample": 0, "gather_window": 0,
            "write_priorities": 0, "scaled_noise": 0, "apply_delta": 0}
_LOCK = threading.Lock()
_BUFFERS: dict = {}


def count_launch(name: str) -> None:
    """Add one to a kernel's launch count."""
    with _LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launches() -> dict:
    with _LOCK:
        return dict(LAUNCHES)


def device_buffer(name: str, device: torch.device, numel: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The zeroed buffer ``name`` of the current stream of ``device``
    (numel elements of dtype), allocated at its first request on that
    stream and the same tensor ever after. Kernels keep their tickets and
    cross-launch scratch here, so a call allocates only its outputs; one
    buffer per stream, so calls on two streams never share one. A stream's
    first call must come before any CUDA graph capture on it: the wrapper
    raises otherwise, rather than capture the allocation."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device)
    key = (name, device, stream.cuda_stream)
    with _LOCK:
        if key not in _BUFFERS:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{name}: first call on a stream under CUDA graph "
                    "capture; make one call on the capturing stream first")
            _BUFFERS[key] = torch.zeros(numel, dtype=dtype, device=device)
        return _BUFFERS[key]


def check_cuda(name: str, **tensors) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor."""
    for arg, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def check_dtype(name: str, arg: str, t, *dtypes) -> None:
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: {arg} must be {' or '.join(map(str, dtypes))}"
                         f", got {t.dtype}")


def check_shape(name: str, arg: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
