"""Rainbow agent, acting half: greedy batched act, ε-greedy eval act and the
validation-Q probe (rainbow_tpu/agent.py:91-123).

Noise is explicit: ``generator`` (a torch.Generator on the states' device)
draws fresh noise, ``noise_eps`` (models.dqn.draw_noise) supplies it
pre-drawn, and with neither the net runs μ only (eval mode). The learner
(optimizer, loss, updates) comes with the learner slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.models.dqn import forward_head


def act(params: dict, cfg: RainbowConfig, action_space: int,
        states: torch.Tensor, generator: Optional[torch.Generator] = None,
        noise_eps: Optional[dict] = None) -> torch.Tensor:
    """Greedy batched action selection, argmax_a Σ_z z·p (reference
    agent.py:53-55), as (B,) int64. With cfg.per_env_noise each env row gets
    its own noise draw."""
    return forward_head(params, cfg, action_space, states, generator,
                        per_sample_noise=cfg.per_env_noise,
                        noise_eps=noise_eps).action


def act_e_greedy(params: dict, cfg: RainbowConfig, action_space: int,
                 states: torch.Tensor, generator: torch.Generator,
                 epsilon: float = 0.001) -> torch.Tensor:
    """ε-greedy evaluation policy (reference agent.py:58-59); the net runs
    μ only. ``generator`` draws the exploration on the states' device."""
    greedy = act(params, cfg, action_space, states)
    b, dev = greedy.shape[0], greedy.device
    rand = torch.randint(0, action_space, (b,), generator=generator,
                         device=dev)
    explore = torch.rand((b,), generator=generator, device=dev) < epsilon
    return torch.where(explore, rand, greedy)


def evaluate_q(params: dict, cfg: RainbowConfig, action_space: int,
               states: torch.Tensor) -> torch.Tensor:
    """Max expected Q per state (reference agent.py:110-112), batched, μ only."""
    return forward_head(params, cfg, action_space, states).max_q
