"""rainbow-tpu on PyTorch and CUDA: the batched Rainbow actor and its
evaluation on an NVIDIA H100.

A port of the JAX package ``rainbow_tpu`` that stays beside it as the
reference. Public functions keep the JAX package's layouts (NHWC frame
stacks, (E, C, 7056) replay frames, (B, A, atoms) distributions) so the two
can be compared like for like. Hot computations run as hand-written Hopper
kernels (``rainbow_tpu_torch.kernels``) on CUDA tensors and as their plain
PyTorch versions on CPU tensors; nothing falls back from one to the other.
"""
from rainbow_tpu_torch.config import (PRESETS, RainbowConfig, canonical,
                                      data_efficient, throughput)

__all__ = ["PRESETS", "RainbowConfig", "canonical", "data_efficient",
           "throughput"]
