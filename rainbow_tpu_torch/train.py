"""The batched actor's per-iteration step, the batched-PER learner round and
the fused training iteration (rainbow_tpu/train.py:45-138, 230-296,
351-418, 451-463).

One actor iteration appends the transition that just ended to the replay,
advances the frame stack (one launch of the append + frame-stack kernel on
CUDA) and selects every env's next action in one forward. A training
iteration runs a learner round first, against the replay as it was before
this iteration's append, then the masked target sync, then the actor
iteration. The stack, the replay and the agent are updated in place (the
JAX package donates them instead); only the caller's fetch of the actions
waits for the device.

Random draws come from the agent's generator. A caller that must match
draws made elsewhere (the tests, which replay the JAX package's) passes
them in ``draws``: ``"u"`` the round's stratified uniforms, ``"target"``
the target forward's per-row noise, ``"online"`` the per-update online
noise (models.dqn.draw_noise with lead (num_learns,)), ``"act"`` the act
forward's noise.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.models.dqn import draw_noise, forward_head
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


def learner_round(agent: ag.AgentState, rep: rp.ReplayState,
                  cfg: RainbowConfig, action_space: int, num_learns: int,
                  beta, draws: Optional[dict] = None) -> torch.Tensor:
    """The batched-PER learner round (JAX train.py:351-418): one stratified
    draw of all ``num_learns`` batches against the round-start priorities,
    one windowed gather, one target-net forward over all of the round's
    rows with per-row noise, then per update the double-Q target, the
    gradient and clip + Adam with the online noise of that update (one draw
    shared over its batch), and one priority write-back at the end. Updates
    ``agent`` and ``rep.priorities``/``max_priority`` in place; returns the
    mean loss as a 0-d device tensor. The sequential PER round
    (cfg.sequential_per, JAX train.py:266, 457) is not ported and raises."""
    if cfg.sequential_per:
        raise NotImplementedError(
            "learner_round: cfg.sequential_per (the sequential PER round) is "
            "not ported; only the batched round is")
    draws = draws or {}
    g = agent.generator
    nb, bs = num_learns, cfg.batch_size
    big = rp.sample_many(rep, beta, num_batches=nb, batch_size=bs,
                         history=cfg.history_length, n_step=cfg.multi_step,
                         discount=cfg.discount, generator=g,
                         u=draws.get("u"))
    dev = big["weights"].device
    ns_flat = rp.states_to_float(
        big["next_states"].reshape((nb * bs,) + big["next_states"].shape[2:]))
    target_eps = draws.get("target")
    if target_eps is None:
        target_eps = draw_noise(cfg, action_space, g, (nb * bs,), dev)
    with torch.no_grad():
        pns_target = forward_head(agent.target_params, cfg, action_space,
                                  ns_flat, dist="probs",
                                  noise_eps=target_eps).dist
    del ns_flat
    pns_target = pns_target.view(nb, bs, action_space, cfg.atoms)
    online = draws.get("online")
    if online is None:
        online = draw_noise(cfg, action_space, g, (nb,), dev)
    losses = []
    for u in range(nb):
        batch = {k: big[k][u] for k in ("actions", "returns", "nonterminals",
                                         "weights")}
        batch["states"] = rp.states_to_float(big["states"][u])
        batch["next_states"] = rp.states_to_float(big["next_states"][u])
        eps = {name: (e_in[u], e_out[u])
               for name, (e_in, e_out) in online.items()}
        grads, l = ag.compute_update_pretarget(agent, cfg, action_space,
                                               batch, pns_target[u], eps)
        ag.apply_grads(agent, cfg, grads)
        losses.append(l)
    losses = torch.stack(losses)
    rp.update_priorities(rep, big["idxs"].reshape(-1), losses.reshape(-1),
                         cfg.priority_exponent)
    return losses.mean()


def train_iter_packed(cfg: RainbowConfig, action_space: int,
                      num_learns: int, agent: ag.AgentState,
                      stack: torch.Tensor, rep: rp.ReplayState, prev_actions,
                      obs, reset_packed, reset_idx, rewards, dones, kinds,
                      beta, sync_target: bool, draws: Optional[dict] = None):
    """One fused training iteration (JAX train.py:230-296): with
    ``num_learns`` > 0 a learner round against the pre-append replay and,
    if ``sync_target``, the hard target sync; then the transition append +
    frame-stack advance and the next actions, with fresh per-env noise.
    ``num_learns`` = 0 is the warm-up form; a round with
    cfg.sequential_per raises (see learner_round). The act draws fresh
    noise on every call, warm-up included: the JAX package's Trainer
    redraws before each warm-up iteration at the canonical cadence
    (train.py:1042-1051), where JAX's function alone would reuse its noise
    key. Updates
    ``agent``, ``stack`` and ``rep`` in place; returns (actions (N,) int64,
    mean loss, 0 without a round), both on the device."""
    draws = draws or {}
    loss = torch.zeros((), dtype=torch.float32, device=stack.device)
    if num_learns:
        loss = learner_round(agent, rep, cfg, action_space, num_learns, beta,
                             draws)
        if sync_target:
            ag.update_target(agent)
    _update_core(cfg, stack, rep, prev_actions, obs, reset_packed, reset_idx,
                 rewards, dones, kinds)
    actions = ag.act(agent.params, cfg, action_space,
                     to_network_input(stack), agent.generator,
                     draws.get("act"))
    return actions, loss
