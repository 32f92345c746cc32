"""C51 distributional support (rainbow_tpu/ops/c51.py).

Only the support is needed by the acting path; the projection and the loss
come with the learner.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _support(v_min: float, v_max: float, atoms: int,
             device: torch.device) -> torch.Tensor:
    return torch.linspace(v_min, v_max, atoms, dtype=torch.float32,
                          device=device)


def support_vector(v_min: float, v_max: float, atoms: int,
                   device="cpu") -> torch.Tensor:
    """z = linspace(V_min, V_max, atoms), float32 (reference agent.py:18).

    May differ from ``jnp.linspace`` in the last bit of some atoms: both
    round in float32, in different orders. Cached per device, so the
    returned tensor is shared: do not write to it.
    """
    return _support(float(v_min), float(v_max), atoms, torch.device(device))
