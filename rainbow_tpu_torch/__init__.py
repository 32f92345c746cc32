"""rainbow-tpu on PyTorch and CUDA: the batched Rainbow actor, the
batched-PER learner, evaluation, the Trainer with its checkpoints, the
command line (``python -m rainbow_tpu_torch.cli``) and the sweep, on an
NVIDIA H100.

A port of the JAX package ``rainbow_tpu`` that stays beside it as the
reference. Public functions keep the JAX package's layouts (NHWC frame
stacks, (E, C, 7056) replay frames, (B, A, atoms) distributions) so the two
can be compared like for like. Hot computations run as hand-written Hopper
kernels (``rainbow_tpu_torch.kernels``) on CUDA tensors and as their plain
PyTorch versions on CPU tensors; nothing falls back from one to the other.
"""
from rainbow_tpu_torch.config import (PRESETS, RainbowConfig, canonical,
                                      data_efficient, throughput)

__all__ = ["PRESETS", "RainbowConfig", "Trainer", "canonical",
           "data_efficient", "throughput"]


def __getattr__(name):
    if name == "Trainer":  # imported on first use: it pulls in the model
        from rainbow_tpu_torch.train import Trainer
        return Trainer
    raise AttributeError(f"module 'rainbow_tpu_torch' has no attribute "
                         f"{name!r}")
