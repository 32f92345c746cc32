"""The batched actor's per-iteration step (rainbow_tpu/train.py:45-138).

One actor iteration appends the transition that just ended to the replay,
advances the frame stack (one launch of the append + frame-stack kernel on
CUDA) and selects every env's next action in one forward. The stack and the
replay are updated in place (the JAX package donates them instead); only
the caller's fetch of the actions waits for the device. The learner round,
target sync and the Trainer come with the learner slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.ops.preprocess import (append_framestack,
                                              to_network_input)
from rainbow_tpu_torch.replay import prioritized as rp


def make_env_factory(cfg: RainbowConfig) -> Callable:
    if cfg.env_backend == "fake":
        from rainbow_tpu_torch.envs.fake import FakeAtariEnv

        def factory(num_envs: int, training: bool = True, seed_offset: int = 0):
            return FakeAtariEnv(num_envs, seed=cfg.seed + seed_offset,
                                episode_len=50, life_every=cfg.life_every,
                                training=training)
        return factory

    from rainbow_tpu_torch.envs.engine import BatchedEnv

    def factory(num_envs: int, training: bool = True, seed_offset: int = 0):
        return BatchedEnv(cfg.game, num_envs, cfg.seed + seed_offset,
                          cfg.max_episode_length, training=training)
    return factory


def _update_core(cfg: RainbowConfig, stack: torch.Tensor,
                 rep: rp.ReplayState, prev_actions, obs, reset_packed,
                 reset_idx, rewards, dones, kinds) -> None:
    """Append the just-completed transition (pre-step newest frame + action
    + clipped reward + done, reference main.py:155-157) and advance the frame
    stack, in place."""
    append_framestack(stack, obs, reset_packed, reset_idx, kinds, rep,
                      prev_actions, rewards, dones, cfg.reward_clip)


def actor_step(params: dict, generator: Optional[torch.Generator],
               cfg: RainbowConfig, action_space: int, stack: torch.Tensor,
               rep: rp.ReplayState, prev_actions, obs, reset_frames, rewards,
               dones, kinds, noise_eps: Optional[dict] = None) -> torch.Tensor:
    """Transition append + frame-stack advance + next-action selection, with
    the dense (N, 84, 84) reset frames. Updates ``stack`` and ``rep`` in
    place and returns the actions (N,) int64 on the device."""
    n = obs.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=obs.device)
    return actor_step_packed(params, generator, cfg, action_space, stack, rep,
                             prev_actions, obs, reset_frames, idx, rewards,
                             dones, kinds, noise_eps)


_RESET_BUCKETS = (0, 8, 32, 128, 512, 2048, 8192)


def pack_resets(resets: np.ndarray, kinds: np.ndarray):
    """Pack the post-reset frames of the envs that actually reset.

    Returns (packed[K, 84, 84], idx[K] int32) with K the smallest bucket
    ≥ the reset count (capped at N); idx pads with N, rows the update drops.
    Only the reset rows are uploaded instead of all N."""
    n = kinds.shape[0]
    idx = np.flatnonzero(kinds)
    k = len(idx)
    kp = next((min(b, n) for b in _RESET_BUCKETS if b >= k), n)
    out_idx = np.full((kp,), n, np.int32)
    out_idx[:k] = idx
    packed = np.zeros((kp,) + resets.shape[1:], resets.dtype)
    packed[:k] = resets[idx]
    return packed, out_idx


def actor_step_packed(params: dict, generator: Optional[torch.Generator],
                      cfg: RainbowConfig, action_space: int,
                      stack: torch.Tensor, rep: rp.ReplayState, prev_actions,
                      obs, reset_packed, reset_idx, rewards, dones, kinds,
                      noise_eps: Optional[dict] = None) -> torch.Tensor:
    """actor_step with packed reset frames (see pack_resets): one launch of
    the append + frame-stack kernel, then one forward. Noise as in
    agent.act: drawn from ``generator``, or pre-drawn ``noise_eps``."""
    _update_core(cfg, stack, rep, prev_actions, obs, reset_packed, reset_idx,
                 rewards, dones, kinds)
    return ag.act(params, cfg, action_space, to_network_input(stack),
                  generator, noise_eps)


def stage_step(outputs, device) -> tuple:
    """Engine step outputs (obs, resets, rewards, dones, kinds) → the
    device tensors ``actor_step_packed`` takes after ``prev_actions``:
    (obs, reset_packed, reset_idx, rewards, dones, kinds)."""
    obs, resets, rewards, dones, kinds = outputs
    packed, ridx = pack_resets(resets, kinds)
    t = lambda a, dtype=None: torch.from_numpy(
        np.ascontiguousarray(a, dtype)).to(device)
    return (t(obs), t(packed), t(ridx), t(rewards, np.float32),
            t(dones, np.bool_), t(kinds))
