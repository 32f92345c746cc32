"""On-device prioritized n-step replay: the ring state and its append
(rainbow_tpu/replay/prioritized.py).

Each env owns a contiguous ring of ``capacity_per_env`` columns that all envs
write in lockstep at one shared head. Only the newest 84x84 frame of each
transition is stored, flat as (E, C, 7056) uint8 as in the JAX package, and
stacks are rebuilt from ``timestep == 0`` markers when they are read.

Unlike the JAX package, the state is mutable: ``append`` writes the column
in place (JAX donates the buffers instead). ``index``, ``full`` and
``max_priority`` are 0-d tensors on the ring's device, so appending never
waits for the host. The samplers and ``update_priorities`` belong to the
learner.
"""
from __future__ import annotations

import dataclasses

import torch

from rainbow_tpu_torch.device import resolve_device


@dataclasses.dataclass
class ReplayState:
    frames: torch.Tensor       # uint8 (E, C, F*F) newest frame per transition
    actions: torch.Tensor      # int32 (E, C)
    rewards: torch.Tensor      # float32 (E, C)
    timesteps: torch.Tensor    # int32 (E, C), 0 = episode start
    nonterminal: torch.Tensor  # bool (E, C)
    priorities: torch.Tensor   # float32 (E, C), already ^ω
    index: torch.Tensor        # int32 0-d, shared ring write head
    full: torch.Tensor         # bool 0-d, the ring has wrapped
    t: torch.Tensor            # int32 (E,), per-env episode step counter
    max_priority: torch.Tensor  # float32 0-d, monotone (reference memory.py:60)


def init_replay(num_envs: int, capacity_per_env: int, frame_size: int = 84,
                device="cuda") -> ReplayState:
    dev = resolve_device(device)
    e, c, f = num_envs, capacity_per_env, frame_size
    z = lambda *shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    return ReplayState(
        frames=z(e, c, f * f, dtype=torch.uint8),
        actions=z(e, c, dtype=torch.int32),
        rewards=z(e, c, dtype=torch.float32),
        timesteps=z(e, c, dtype=torch.int32),
        nonterminal=z(e, c, dtype=torch.bool),
        priorities=z(e, c, dtype=torch.float32),
        index=z(dtype=torch.int32),
        full=z(dtype=torch.bool),
        t=z(e, dtype=torch.int32),
        max_priority=torch.ones((), dtype=torch.float32, device=dev),
    )


def append(state: ReplayState, frames: torch.Tensor, actions: torch.Tensor,
           rewards: torch.Tensor, terminals: torch.Tensor) -> ReplayState:
    """Append one lockstep transition per env at the shared write head, in
    place, and return ``state``.

    Mirrors reference memory.py:105-108: stores (t, frame, action, reward,
    ¬terminal) at max priority; the episode counter resets to 0 on terminal.
    ``frames`` is uint8 (E, 84, 84), the newest preprocessed frame only.
    CPU rings only: on CUDA the append is part of the append + frame-stack
    kernel's launch, through ops.preprocess.append_framestack.
    """
    if state.frames.is_cuda:
        raise ValueError("append takes a CPU ring; on CUDA append through "
                         "ops.preprocess.append_framestack")
    return append_plain(state, frames, actions, rewards, terminals)


def append_plain(state: ReplayState, frames: torch.Tensor,
                 actions: torch.Tensor, rewards: torch.Tensor,
                 terminals: torch.Tensor) -> ReplayState:
    """The replay half of the append + frame-stack kernel's plain version;
    reads the write head on the host."""
    i = int(state.index)
    e = state.priorities.shape[0]
    terminals = terminals.to(torch.bool)
    state.frames[:, i] = frames.reshape(e, -1)
    state.actions[:, i] = actions.to(torch.int32)
    state.rewards[:, i] = rewards.to(torch.float32)
    state.timesteps[:, i] = state.t
    state.nonterminal[:, i] = ~terminals
    state.priorities[:, i] = state.max_priority
    new_index = (i + 1) % state.priorities.shape[1]
    state.index.fill_(new_index)
    state.full |= new_index == 0
    state.t.copy_(torch.where(terminals, torch.zeros_like(state.t),
                              state.t + 1))
    return state


def stored_count(state: ReplayState) -> torch.Tensor:
    """Stored transitions over all envs, as a 0-d tensor on the ring's device."""
    e, c = state.priorities.shape
    return torch.where(state.full, c, state.index) * e


def all_states(state: ReplayState, history: int) -> torch.Tensor:
    """Every stored frame stack, (E*C, 84, 84, history) float32 NHWC — the
    validation-scan iterator of reference memory.py:162-180, vectorised.
    Blanks stacks across episode starts exactly as the reference does
    (backward pass over ``timestep==0`` markers only)."""
    e, c = state.priorities.shape
    dev = state.frames.device
    i = torch.arange(c, device=dev)
    offs = torch.arange(-history + 1, 1, device=dev)
    wi = (i[:, None] + offs[None, :]) % c            # (C, h)
    frames_w = state.frames[:, wi]                   # (E, C, h, F*F)
    firsts = (state.timesteps[:, wi] == 0).reshape(e * c, history)
    blank = [torch.zeros_like(firsts[:, 0]) for _ in range(history)]
    for t in range(history - 2, -1, -1):
        blank[t] = blank[t + 1] | firsts[:, t + 1]
    blank = torch.stack(blank, dim=1)
    f = int(round(frames_w.shape[-1] ** 0.5))
    fr = frames_w.reshape(e * c, history, f, f)
    fr = torch.where(blank[:, :, None, None], torch.zeros_like(fr), fr)
    return fr.permute(0, 2, 3, 1).to(torch.float32) / 255.0
