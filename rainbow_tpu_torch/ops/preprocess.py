"""Device-side frame-stack maintenance (rainbow_tpu/ops/preprocess.py), and
the replay append fused with it.

The stack for all N envs is one uint8 (N, 84, 84, H) tensor. The engine's
reset_kind codes reproduce the reference's three buffer behaviours:

  kind 0 — normal step: roll, append the step observation (env.py:68).
  kind 1 — life-loss continuation: the terminal observation was rolled in by
           the step AND the post-no-op frame follows it (env.py:36-38).
  kind 2 — full reset: zeroed buffer with only the reset frame (env.py:41-52).

``append_framestack`` is the per-step update of the actor and of the
evaluator: on CUDA tensors it is one launch of the append + frame-stack
kernel (kernels/append_framestack.py), on CPU tensors its plain version
below. Both update ``stack`` (and the replay) in place.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.kernels import append_framestack as kc
from rainbow_tpu_torch.replay import prioritized as rp


def init_framestack(num_envs: int, history: int, first_frames,
                    device="cuda") -> torch.Tensor:
    """Zeroed stack with the initial reset frame in the newest slot."""
    dev = resolve_device(device)
    first = torch.as_tensor(np.asarray(first_frames)).to(dev)
    f = first.shape[-1]
    stack = torch.zeros((num_envs, f, f, history), dtype=torch.uint8,
                        device=dev)
    stack[..., -1] = first
    return stack


def update_framestack(stack: torch.Tensor, obs: torch.Tensor,
                      reset_frames: torch.Tensor,
                      kinds: torch.Tensor) -> torch.Tensor:
    """Advance the (N, 84, 84, H) uint8 stack by one step per reset_kind,
    with dense (N, 84, 84) reset frames; returns a new stack and leaves
    ``stack`` as it was. The plain version, for CPU tensors only: on the
    card the step is ``append_framestack`` (with ``reset_idx`` = arange(N)
    for dense reset frames)."""
    if stack.is_cuda:
        raise ValueError("update_framestack is the plain version and takes "
                         "CPU tensors; on CUDA tensors use append_framestack")
    return _update_framestack_plain(stack, obs, reset_frames, kinds)


def _update_framestack_plain(stack, obs, reset_frames, kinds):
    rolled = torch.cat([stack[..., 1:], obs[..., None]], dim=-1)
    life = torch.cat([stack[..., 2:], obs[..., None],
                      reset_frames[..., None]], dim=-1)
    fresh = torch.cat([torch.zeros_like(stack[..., :-1]),
                       reset_frames[..., None]], dim=-1)
    k = kinds.to(torch.int64)[:, None, None, None]
    return torch.where(k == 0, rolled, torch.where(k == 1, life, fresh))


def to_network_input(stack_u8: torch.Tensor) -> torch.Tensor:
    """uint8 stack → float32 [0,1] NHWC network input (reference env.py:29)."""
    return stack_u8.to(torch.float32) / 255.0


def append_framestack_plain(stack: torch.Tensor, obs: torch.Tensor,
                            reset_packed: torch.Tensor,
                            reset_idx: torch.Tensor, kinds: torch.Tensor,
                            rep: Optional[rp.ReplayState] = None,
                            actions: Optional[torch.Tensor] = None,
                            rewards: Optional[torch.Tensor] = None,
                            dones: Optional[torch.Tensor] = None,
                            reward_clip: float = 0.0) -> None:
    """Plain version of the append + frame-stack kernel.

    Scatters the packed reset frames (rows whose ``reset_idx`` is N are
    padding and dropped, train.py:135-136), appends the transition that
    ended (the pre-step newest frame, ``actions``, ``rewards`` clipped to
    ±reward_clip when it is > 0, ``dones``) to ``rep`` if one is given, then
    advances ``stack``. Updates ``stack`` and ``rep`` in place.
    """
    n = obs.shape[0]
    reset_frames = torch.zeros_like(obs)
    keep = reset_idx < n
    reset_frames[reset_idx[keep].to(torch.int64)] = reset_packed[keep]
    if rep is not None:
        if reward_clip > 0:
            rewards = rewards.clamp(-reward_clip, reward_clip)
        rp.append_plain(rep, stack[..., -1], actions, rewards, dones)
    stack.copy_(_update_framestack_plain(stack, obs, reset_frames, kinds))


def append_framestack(stack: torch.Tensor, obs: torch.Tensor,
                      reset_packed: torch.Tensor, reset_idx: torch.Tensor,
                      kinds: torch.Tensor,
                      rep: Optional[rp.ReplayState] = None,
                      actions: Optional[torch.Tensor] = None,
                      rewards: Optional[torch.Tensor] = None,
                      dones: Optional[torch.Tensor] = None,
                      reward_clip: float = 0.0) -> None:
    """One step of the frame stack, and of the replay when ``rep`` is given,
    in place: the kernel on CUDA tensors, the plain version on CPU ones.
    Arguments as in ``append_framestack_plain``."""
    if stack.is_cuda:
        kc.append_framestack(stack, obs, reset_packed, reset_idx, kinds,
                             rep, actions, rewards, dones, reward_clip)
    else:
        append_framestack_plain(stack, obs, reset_packed, reset_idx, kinds,
                                rep, actions, rewards, dones, reward_clip)
