"""On-device prioritized n-step replay: the ring state, its append, the
batched prioritized sampler and the priority write-back
(rainbow_tpu/replay/prioritized.py).

Each env owns a contiguous ring of ``capacity_per_env`` columns that all envs
write in lockstep at one shared head. Only the newest 84x84 frame of each
transition is stored, flat as (E, C, 7056) uint8 as in the JAX package, and
stacks are rebuilt from ``timestep == 0`` markers when they are read.

Unlike the JAX package, the state is mutable: ``append`` writes the column
in place (JAX donates the buffers instead). ``index``, ``full`` and
``max_priority`` are 0-d tensors on the ring's device, so appending never
waits for the host; nor does sampling or the priority write-back.

The sampler (``sample_many``, and ``sample`` for one batch): one
stratified descent over the masked priorities (K5), then one windowed uint8
gather with episode blanking, n-step returns and IS weights normalised per
batch (K6); the write-back (``update_priorities``) is K7. Each runs as its
hand-written kernel (kernels/replay.py) on a CUDA ring and as its
``*_plain`` version on a CPU ring.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.kernels import replay as k_replay
from rainbow_tpu_torch.kernels.replay import window_fields


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


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _stratified_find(leaves: torch.Tensor, batch_size: int,
                     u: torch.Tensor):
    """Stratified prefix-sum descent over a stateless sum-tree (JAX
    prioritized.py:102-131; reference memory.py:64-82): builds the tree's
    levels from ``leaves`` padded to a power of two and descends all
    ``batch_size`` draws together, one level per step. Draw j lands in
    segment j: value (j + u_j)·total/B, with ``u`` (B,) uniform in [0, 1).
    Returns (leaf indices int64, their values, the total)."""
    n = leaves.shape[0]
    padded = torch.zeros((_next_pow2(n),), dtype=leaves.dtype,
                         device=leaves.device)
    padded[:n] = leaves
    levels = [padded]
    while levels[-1].shape[0] > 1:
        levels.append(levels[-1].view(-1, 2).sum(dim=1))
    total = levels[-1][0]
    # total / B as a true division on every device (CUDA multiplies by the
    # reciprocal of a host scalar divisor instead).
    seg = total / torch.full((), float(batch_size), dtype=total.dtype,
                             device=total.device)
    values = (torch.arange(batch_size, dtype=torch.float32,
                           device=leaves.device) + u) * seg
    idx = torch.zeros((batch_size,), dtype=torch.int64, device=leaves.device)
    # Go right iff the value exceeds the left child's sum, less that sum
    # (reference memory.py:72-76).
    for level in levels[-2::-1]:
        left = level[2 * idx]
        go_right = values > left
        idx = 2 * idx + go_right
        values = values - torch.where(go_right, left, torch.zeros_like(left))
    idx = idx.clamp(max=n - 1)  # total-overshoot clamp (memory.py:70-71)
    return idx, padded[idx], total


def _valid_time_mask(capacity: int, index: torch.Tensor, history: int,
                     n_step: int) -> torch.Tensor:
    """(C,) bool: positions whose (−history+1 .. +n) window does not cross
    the write head (reference memory.py:131 as a mask)."""
    pos = torch.arange(capacity, dtype=torch.int32, device=index.device)
    ahead = (index - pos) % capacity
    behind = (pos - index) % capacity
    return (ahead > n_step) & (behind >= history)


def _blank_masks(firsts: torch.Tensor, history: int,
                 n_step: int) -> torch.Tensor:
    """Episode-boundary blanking over a (B, history+n) window of
    ``timestep == 0`` markers (reference memory.py:114-120)."""
    w = history + n_step
    blank = [torch.zeros_like(firsts[:, 0]) for _ in range(w)]
    for t in range(history - 2, -1, -1):      # frames before an episode start
        blank[t] = blank[t + 1] | firsts[:, t + 1]
    for t in range(history, history + n_step):  # frames after a terminal
        blank[t] = blank[t - 1] | firsts[:, t]
    return torch.stack(blank, dim=1)


def _masked_flat_priorities(state: ReplayState, history: int,
                            n_step: int) -> torch.Tensor:
    e, c = state.priorities.shape
    valid = _valid_time_mask(c, state.index, history, n_step)
    return torch.where(valid[None, :], state.priorities,
                       torch.zeros_like(state.priorities)).reshape(-1)


def stratified_sample_plain(state: ReplayState, u: torch.Tensor,
                            history: int, n_step: int):
    """Plain version of the stratified-sample kernel (K5): the priorities
    masked around the write head, then one stratified draw per entry of
    ``u``. Returns (leaf indices (B,) int64, their priorities, the total)."""
    flat = _masked_flat_priorities(state, history, n_step)
    return _stratified_find(flat, u.shape[0], u=u)


def _gather_unnormalised(state: ReplayState, idx: torch.Tensor,
                         p: torch.Tensor, total: torch.Tensor, beta,
                         history: int, n_step: int, discount: float) -> dict:
    """The windowed gather and batch assembly for flat indices ``idx``
    (JAX prioritized.py:157-209): the blanked uint8 ``window`` (B,
    history+n, F·F) in place of the stacks. IS weights are not yet
    normalised."""
    e_count, c = state.priorities.shape
    e, i = idx // c, idx % c
    offs = torch.arange(-history + 1, n_step + 1, device=idx.device)
    wi = (i[:, None] + offs[None, :]) % c
    eb = e[:, None]
    frames_w = state.frames[eb, wi]            # (B, h+n, F*F) uint8
    blank = _blank_masks(state.timesteps[eb, wi] == 0, history, n_step)
    frames_w = frames_w.masked_fill(blank[:, :, None], 0)
    rew_w = state.rewards[eb, wi].masked_fill(blank, 0.0)
    nt_w = state.nonterminal[eb, wi] & ~blank
    gammas = discount ** torch.arange(n_step, dtype=torch.float32,
                                      device=idx.device)
    # IS weights (N·p)^−β, N = stored transitions (reference
    # memory.py:149-154). Zero-mass hits and an all-invalid buffer give
    # weight 0, never NaN.
    stored = torch.where(state.full, c, state.index) * e_count
    probs = p / total.clamp(min=1e-12)
    weights = (stored.to(torch.float32) * probs) ** (-beta)
    weights = torch.where((p > 0) & (total > 0), weights,
                          torch.zeros_like(weights))
    return {
        "idxs": idx,
        "window": frames_w,
        "actions": state.actions[eb[:, 0], wi[:, history - 1]],
        "returns": rew_w[:, history - 1:history - 1 + n_step] @ gammas,
        "nonterminals": nt_w[:, history + n_step - 1].to(torch.float32),
        "weights": weights,
    }


def gather_window_plain(state: ReplayState, idx: torch.Tensor,
                        p: torch.Tensor, total: torch.Tensor, beta: float,
                        num_batches: int, batch_size: int, history: int,
                        n_step: int, discount: float) -> dict:
    """Plain version of the windowed-gather kernel (K6): the round's
    batches from the draws ``idx``, ``p`` (in draw order) and ``total``.
    Draw j goes to row j // nb of batch j % nb; IS weights are normalised
    per batch by that batch's max, floored at 1e-12."""
    nb, bs = num_batches, batch_size
    # Gather straight into (batch, row) order.
    order = torch.arange(nb * bs, device=idx.device).view(bs, nb).T.reshape(-1)
    out = _gather_unnormalised(state, idx[order], p[order], total, beta,
                               history, n_step, discount)
    out = {k: v.reshape((nb, bs) + v.shape[1:]) for k, v in out.items()}
    wmax = out["weights"].amax(dim=1, keepdim=True).clamp(min=1e-12)
    out["weights"] = out["weights"] / wmax
    out["weights_max"] = wmax[:, 0]
    return window_fields(out.pop("window"), history, n_step, out)


def sample_many(state: ReplayState, beta, *, num_batches: int,
                batch_size: int, history: int, n_step: int, discount: float,
                generator: Optional[torch.Generator] = None,
                u: Optional[torch.Tensor] = None) -> dict:
    """A learner round's batches in one stratified pass against the current
    priorities (JAX prioritized.py:247-277, ``states_uint8=True``). Fields
    have leading shape (num_batches, batch_size): ``idxs`` (flat leaf
    indices for update_priorities), ``states`` and ``next_states`` uint8
    (…, 84, 84, history), ``actions``, ``returns``, ``nonterminals``,
    ``weights``, and ``weights_max`` (num_batches,).

    Segment j of the stratification goes to batch j % num_batches, and IS
    weights are normalised per batch by that batch's max, floored at
    1e-12. ``u`` (num_batches·batch_size,) replaces the uniform draw from
    ``generator``. On a CUDA ring: one call of the stratified-sample kernel
    and one of the windowed-gather kernel; on a CPU ring their plain
    versions."""
    nb, bs = num_batches, batch_size
    dev = state.priorities.device
    if u is None:
        u = torch.rand((nb * bs,), generator=generator, device=dev)
    beta = float(beta)
    if state.priorities.is_cuda:
        idx, p, total = k_replay.stratified_sample(state, u, history, n_step)
        return k_replay.gather_window(state, idx, p, total, beta, nb, bs,
                                      history, n_step, discount)
    idx, p, total = stratified_sample_plain(state, u, history, n_step)
    return gather_window_plain(state, idx, p, total, beta, nb, bs, history,
                               n_step, discount)


def sample(state: ReplayState, beta, *, batch_size: int, history: int,
           n_step: int, discount: float,
           generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None) -> dict:
    """One prioritized batch (JAX prioritized.py:220-241; reference
    memory.py:124-155): ``batch_size`` stratified draws against the current
    priorities and their windowed gather, sample_many with one batch.
    Returns ``idxs`` (B,), ``states`` and ``next_states`` float32 (B, 84, 84,
    history) in [0, 1], ``actions``, ``returns``, ``nonterminals``,
    ``weights`` normalised by the batch max (floored at 1e-12), and that
    max as ``weights_max``. ``u`` (B,) replaces the uniform draw from
    ``generator``. On a CUDA ring one call each of the stratified-sample and
    the windowed-gather kernels."""
    out = sample_many(state, beta, num_batches=1, batch_size=batch_size,
                      history=history, n_step=n_step, discount=discount,
                      generator=generator, u=u)
    out = {k: v[0] for k, v in out.items()}
    for k in ("states", "next_states"):
        out[k] = states_to_float(out[k])
    return out


def states_to_float(stacks: torch.Tensor) -> torch.Tensor:
    """uint8 (…, F, F, H) stacks → float32 in [0, 1] (reference env.py:29)."""
    return stacks.to(torch.float32) / 255.0


def update_priorities(state: ReplayState, idxs: torch.Tensor,
                      losses: torch.Tensor,
                      priority_exponent: float) -> ReplayState:
    """Write back ``loss^ω`` at the flat indices ``idxs`` and raise the
    monotone max (reference memory.py:157-159), in place on the device.
    ``idxs`` and ``losses`` are (nb, bs) as sample_many returns them, or
    (B,) in draw order. On a CUDA ring one launch of the write-back kernel,
    which writes the last of consecutive draws of one leaf; on a CPU ring
    the plain version, where one of a repeated index's writes wins."""
    if state.priorities.is_cuda:
        k_replay.write_priorities(state, idxs, losses, priority_exponent)
        return state
    return update_priorities_plain(state, idxs, losses, priority_exponent)


def update_priorities_plain(state: ReplayState, idxs: torch.Tensor,
                            losses: torch.Tensor,
                            priority_exponent: float) -> ReplayState:
    """Plain version of the write-back kernel (K7)."""
    p = losses.reshape(-1) ** priority_exponent
    state.priorities.view(-1)[idxs.reshape(-1)] = p
    torch.maximum(state.max_priority, p.max(), out=state.max_priority)
    return state
