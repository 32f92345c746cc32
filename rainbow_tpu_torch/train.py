"""The batched actor's per-iteration step, the single-device learner round
(batched or sequential PER, the one-shard case of parallel/learner.py),
the fused training iteration over one shard or several, and the Trainer
(rainbow_tpu/train.py:45-316, 351-448, 451-1165).

One actor iteration appends the transition that just ended to the replay,
advances the frame stack (one launch of the append + frame-stack kernel on
CUDA) and selects every env's next action in one forward. A training
iteration runs a learner round first, against the replay as it was before
this iteration's append, then the masked target sync, then the actor
iteration. The stack, the replay and the agent are updated in place (the
JAX package donates them instead); only the caller's fetch of the actions
waits for the device. The Trainer schedules those iterations: the learn
cadence, β, the target sync, evaluation and checkpoints, and its side
paths: the pipelined actor, asynchronous evaluation and delta uploads.

Noise comes from the agent's noise stream, the replay's uniforms from its
generator. A caller that must match draws made elsewhere (the tests, which
replay the JAX package's) passes them in ``draws``: ``"u"`` the round's
stratified uniforms, ``"target"`` the target forward's noise, ``"online"``
the per-update online noise (models.dqn.draw_noise with lead (num_learns,)
for both in the sequential round, per row for the batched round's target),
``"act"`` the act forward's noise. The Trainer passes the act noise
itself, to hold it between redraws as the JAX package's Trainer does.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch import checkpoint as ckpt
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.envs.engine import delta_bucket
from rainbow_tpu_torch.kernels import delta as k10
from rainbow_tpu_torch.models.dqn import draw_noise
from rainbow_tpu_torch.models.noisy import NoiseStream
from rainbow_tpu_torch.ops.preprocess import (append_framestack,
                                              init_framestack,
                                              to_network_input)
from rainbow_tpu_torch.parallel.learner import (Shards, distributed_round,
                                                replicate)
from rainbow_tpu_torch.parallel.mesh import indexed, make_mesh, world
from rainbow_tpu_torch.parallel.multihost import broadcast_floats
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch.utils.logging import Timer, log, span
from rainbow_tpu_torch.utils.plotting import plot_line


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


def actor_step(params: dict, noise: Optional[NoiseStream],
               cfg: RainbowConfig, action_space: int, stack: torch.Tensor,
               rep: rp.ReplayState, prev_actions, obs, reset_frames, rewards,
               dones, kinds, noise_eps: Optional[dict] = None) -> torch.Tensor:
    """Transition append + frame-stack advance + next-action selection, with
    the dense (N, 84, 84) reset frames. Updates ``stack`` and ``rep`` in
    place and returns the actions (N,) int64 on the device."""
    n = obs.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=obs.device)
    return actor_step_packed(params, noise, cfg, action_space, stack, rep,
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


def actor_step_packed(params: dict, noise: Optional[NoiseStream],
                      cfg: RainbowConfig, action_space: int,
                      stack: torch.Tensor, rep: rp.ReplayState, prev_actions,
                      obs, reset_packed, reset_idx, rewards, dones, kinds,
                      noise_eps: Optional[dict] = None) -> torch.Tensor:
    """actor_step with packed reset frames (see pack_resets): one launch of
    the append + frame-stack kernel, then one forward. Noise as in
    agent.act: drawn from the stream ``noise``, or pre-drawn ``noise_eps``."""
    _update_core(cfg, stack, rep, prev_actions, obs, reset_packed, reset_idx,
                 rewards, dones, kinds)
    return ag.act(params, cfg, action_space, to_network_input(stack), noise,
                  noise_eps)


def _host_step(obs_form, resets, rewards, dones, kinds) -> list:
    """One engine step packed on the host, in the order an iteration takes
    it after ``prev_actions``: ``obs_form`` (the observations, or a delta's
    offsets, positions and values), the packed reset frames and their
    indices, rewards float32, dones bool, reset kinds."""
    packed, ridx = pack_resets(resets, kinds)
    return [np.ascontiguousarray(a) for a in (
        *obs_form, packed, ridx, np.asarray(rewards, np.float32),
        np.asarray(dones, np.bool_), kinds)]


def stage_step(outputs, device) -> tuple:
    """Engine step outputs (obs, resets, rewards, dones, kinds) → the
    device tensors ``actor_step_packed`` takes after ``prev_actions``:
    (obs, reset_packed, reset_idx, rewards, dones, kinds)."""
    obs, resets, rewards, dones, kinds = outputs
    return tuple(torch.from_numpy(a).to(device)
                 for a in _host_step((obs,), resets, rewards, dones, kinds))


def delta_offsets(counts: np.ndarray) -> np.ndarray:
    """The exclusive offsets (N + 1,) int32 of a delta's per-env counts
    (engine.step_delta's): env e owns entries [offsets[e], offsets[e + 1]).
    Built on the host beside the counts, so that the delta kernel reads an
    env's segment in two loads instead of summing the counts before it."""
    return np.concatenate(([0], np.cumsum(counts))).astype(np.int32)


def _apply_delta_plain(stack: torch.Tensor, offsets: torch.Tensor,
                       pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Plain version of the delta kernel (K10): the step's observations
    (N, F, F) uint8 rebuilt from the stack's newest plane and the sparse
    delta (JAX train.py:176-195, which takes the counts). Env e owns
    entries [offsets[e], offsets[e + 1]) of ``pos`` (uint16 positions within
    its F·F plane) and ``val`` (uint8), ``offsets`` the delta_offsets of
    the counts; entries past offsets[N] (padding) and positions beyond the
    plane are dropped."""
    n, f = stack.shape[0], stack.shape[1]
    obs = stack[..., -1].reshape(-1).clone()
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    env = torch.repeat_interleave(
        torch.arange(n, device=stack.device), counts)[:pos.shape[0]]
    p = pos[:env.shape[0]].to(torch.int64)
    keep = p < f * f
    obs[(env * (f * f) + p)[keep]] = val[:env.shape[0]][keep]
    return obs.view(n, f, f)


def apply_delta(stack: torch.Tensor, offsets: torch.Tensor,
                pos: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The observations of a delta upload (see _apply_delta_plain): one
    launch of the delta kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if stack.is_cuda:
        return k10.apply_delta(stack, offsets, pos, val)
    return _apply_delta_plain(stack, offsets, pos, val)


def pack_delta(dpos: np.ndarray, dval: np.ndarray):
    """Pad a sparse frame delta (engine.step_delta's uint16 positions and
    uint8 values) to the smallest bucket of envs.engine.DELTA_BUCKETS that
    holds it, as the JAX package does to bound its compiled shapes (JAX
    train.py:159-173); the pad entries lie past the counts' sum and are
    dropped on the device. The Trainer uploads deltas unpadded (PyTorch
    compiles nothing per shape); padded input is what the delta kernel must
    also accept."""
    k = dpos.shape[0]
    kp = delta_bucket(k)
    if kp is None:
        raise ValueError(f"pack_delta: {k} entries exceed the bucket table; "
                         "use the dense path")
    out_pos = np.zeros((kp,), np.uint16)
    out_pos[:k] = dpos
    out_val = np.zeros((kp,), np.uint8)
    out_val[:k] = dval
    return out_pos, out_val


def actor_step_delta(params: dict, noise: Optional[NoiseStream],
                     cfg: RainbowConfig, action_space: int,
                     stack: torch.Tensor, rep: rp.ReplayState, prev_actions,
                     delta_offsets, delta_pos, delta_val, reset_packed,
                     reset_idx, rewards, dones, kinds,
                     noise_eps: Optional[dict] = None) -> torch.Tensor:
    """actor_step_packed with the observations as a sparse delta against the
    stack's newest plane (engine.step_delta, its counts as delta_offsets;
    JAX train.py:200-215)."""
    obs = apply_delta(stack, delta_offsets, delta_pos, delta_val)
    return actor_step_packed(params, noise, cfg, action_space, stack, rep,
                             prev_actions, obs, reset_packed, reset_idx,
                             rewards, dones, kinds, noise_eps)


def learner_round(agent: ag.AgentState, rep: rp.ReplayState,
                  cfg: RainbowConfig, action_space: int, num_learns: int,
                  beta, draws: Optional[dict] = None) -> torch.Tensor:
    """``num_learns`` learner updates against ``rep`` (JAX train.py:451-463):
    the sequential PER round with cfg.sequential_per, else the batched one,
    as the one-shard case of parallel.learner.distributed_round. Updates
    ``agent`` and ``rep.priorities``/``max_priority`` in place; returns the
    mean loss as a 0-d device tensor.

    The batched round (JAX train.py:351-418) takes one stratified draw of
    all ``num_learns`` batches against the round-start priorities, one
    windowed gather, one target-net forward over all of the round's rows
    with per-row noise, then per update the double-Q target, the gradient
    and clip + Adam with the online noise of that update (one draw shared
    over its batch), and one priority write-back at the end; the target and
    online noise are one draw of the noise stream. The sequential round
    (JAX train.py:421-448; reference agent.py:61-100 per update) takes
    ``num_learns`` learn steps, each with fresh online and target noise,
    sampling against the priorities the previous update wrote, then its
    update, clip + Adam and its write-back. Injected ``draws``: ``"u"``,
    ``"online"`` and ``"target"`` (draw_noise dicts), with a leading
    (num_learns,) axis in the sequential round."""
    return distributed_round([agent], [rep], cfg, action_space, num_learns,
                             beta, Shards([rep.priorities.device], cfg,
                                          group=False), [draws or {}])


def train_iter_packed(cfg: RainbowConfig, action_space: int,
                      num_learns: int, agent: ag.AgentState,
                      stack: torch.Tensor, rep: rp.ReplayState, prev_actions,
                      obs, reset_packed, reset_idx, rewards, dones, kinds,
                      beta, sync_target: bool, draws: Optional[dict] = None):
    """One fused training iteration (JAX train.py:230-296): with
    ``num_learns`` > 0 a learner round against the pre-append replay and,
    if ``sync_target``, the hard target sync; then the transition append +
    frame-stack advance and the next actions, with fresh per-env noise.
    ``num_learns`` = 0 is the warm-up form; cfg.sequential_per picks the
    round (see learner_round). The act draws fresh
    noise on every call, warm-up included: the JAX package's Trainer
    redraws before each warm-up iteration at the canonical cadence
    (train.py:1042-1051), where JAX's function alone would reuse its noise
    key. Updates
    ``agent``, ``stack`` and ``rep`` in place; returns (actions (N,) int64,
    mean loss, 0 without a round), both on the device. The one-shard case
    of train_iter_sharded; ``draws`` holds the round's and ``"act"``."""
    draws = draws or {}
    return train_iter_sharded(
        cfg, action_space, num_learns, [agent], [stack], [rep],
        Shards([stack.device], cfg, group=False), prev_actions,
        [(obs, reset_packed, reset_idx, rewards, dones, kinds)], beta,
        sync_target, draws.get("act"), [draws])


def act_sharded(agents: list, cfg: RainbowConfig, action_space: int,
                stacks: list, shards: Shards,
                act_noise: Optional[dict] = None) -> torch.Tensor:
    """Every local shard's actions, in env order, as (N_local,) int64 on the
    first shard device: shard s acts on its stack with its replica and its
    rows of ``act_noise`` (models.dqn.draw_noise over all envs of the
    process group with cfg.per_env_noise, else one shared draw; a fresh
    draw of the shared noise stream when None)."""
    with span("act"):
        if act_noise is None:
            lead = ((shards.count * stacks[0].shape[0],)
                    if cfg.per_env_noise else ())
            act_noise = draw_noise(cfg, action_space, agents[0].noise, lead,
                                   shards.devices[0])
        out = []
        for s, (agent, stack, dev) in enumerate(zip(agents, stacks,
                                                    shards.devices)):
            n = stack.shape[0]
            rows = slice(shards.index(s) * n, (shards.index(s) + 1) * n)
            eps = {k: ((a[rows], b[rows]) if cfg.per_env_noise else (a, b))
                   for k, (a, b) in act_noise.items()}
            eps = {k: (a.to(dev), b.to(dev)) for k, (a, b) in eps.items()}
            out.append(ag.act(agent.params, cfg, action_space,
                              to_network_input(stack), None, eps)
                       .to(shards.devices[0]))
        return out[0] if len(out) == 1 else torch.cat(out)


def train_iter_sharded(cfg: RainbowConfig, action_space: int,
                       num_learns: int, agents: list, stacks: list,
                       reps: list, shards: Shards, prev_actions,
                       tails: list, beta, sync_target: bool,
                       act_noise: Optional[dict] = None,
                       draws: Optional[List[dict]] = None):
    """train_iter_packed over the local shards (one on a single device;
    JAX train.py:319-350, train_iter_mp, for more): with ``num_learns`` > 0
    the round (parallel.learner.distributed_round, with ``draws`` per
    shard) against the pre-append replay shards and, if ``sync_target``,
    every replica's target sync; then per shard the append + frame-stack
    advance of its rows (``tails[s]``: what actor_step_packed takes after
    prev_actions, with the shard's packed resets) and its actions
    (act_sharded, with ``act_noise`` over all envs of the process group).
    Per-shard packed resets stand in for JAX's dense reset frames, which
    exist there only so that every process runs one SPMD program. Returns
    (actions (N_local,) int64 on the first shard device, mean loss)."""
    dev0 = shards.devices[0]
    loss = torch.zeros((), dtype=torch.float32, device=dev0)
    if num_learns:
        loss = distributed_round(agents, reps, cfg, action_space, num_learns,
                                 beta, shards, draws)
        if sync_target:
            for agent in agents:
                ag.update_target(agent)
    at = 0
    with span("append"):
        for stack, rep, dev, tail in zip(stacks, reps, shards.devices,
                                         tails):
            n = stack.shape[0]
            _update_core(cfg, stack, rep, prev_actions[at:at + n].to(dev),
                         *tail)
            at += n
    return act_sharded(agents, cfg, action_space, stacks, shards,
                       act_noise), loss


class Trainer:
    """The training loop (JAX train.py:466-1165): the learn cadence, β
    annealing, the target sync, evaluation with the best-model save,
    metrics and plots, and atomic checkpoints, around one training
    iteration per step (``train_iter_sharded`` over this process's shards,
    after the delta kernel for a delta upload). Host-side scheduling only;
    every iteration's device work is queued, and the waits are the fetch
    of the actions and, pipelined, the settle window.

    ``timer`` (utils.logging.Timer) sums the seconds of each span of the
    loop: ``env`` (the engine step and its upload, ``_stage``; pipelined,
    the wait for the worker that stages it), ``actor`` (the iteration's
    launch and, in the default loop, the fetch of its actions), and,
    pipelined, ``fetch`` and ``settle``. Inside them: ``engine`` (the
    engine's step alone) and ``upload`` (the packing and the copies to the
    device), both on the worker's thread when pipelined; ``launch`` (the
    enqueue of one iteration, ``_launch``); ``device_wait`` (every place
    this thread blocks on device work: the actions' copy in the default
    loop, the fetch and the settle window pipelined). Under a
    torch.profiler each span is also a ``rainbow.<key>`` range.

    Shards: one on ``device``, or, with cfg.data_parallel or as a rank of a
    torch.distributed process group of more than one process, one per
    device of ``devices`` (by default every local CUDA device for
    data_parallel in one process, the ``device`` alone for a rank), each
    with an agent replica, a replay shard and its rows of the env slice.
    A rank runs ``num_envs // world`` envs seeded at rank · 7919; only
    rank 0 evaluates (its results are broadcast, so every rank records the
    same metrics) and writes model.npz, metrics.json, the plots, the
    heartbeat and a profile; every rank writes its own checkpoints, named
    ``<name>.proc{rank}-of-{world}``, and restores from the base path.
    Delta uploads raise under more than one process and stay dense in a
    sharded run, asynchronous evaluation stays off under more than one
    process, as in the JAX package.

    Side paths, as in the JAX Trainer: cfg.sequential_per picks the
    learner round; cfg.delta_uploads sends the engine's sparse frame deltas
    (envs.engine.step_delta, with its dense fallback) where the env has
    them; cfg.pipeline_actor steps the engine and stages step t+1 on a
    worker thread while iteration t launches, with actions executed
    cfg.pipeline_depth steps after the state they came from and at most
    cfg.settle_window iterations unsettled; cfg.async_eval runs evaluations
    on threads and a CUDA stream of their own, against a snapshot of the
    params at the scheduled T."""

    def __init__(self, cfg: RainbowConfig,
                 make_env: Optional[Callable] = None, device="cuda",
                 devices: Optional[list] = None):
        self.cfg = cfg
        self.proc_id, self.num_procs = world()
        self.multi_process = self.num_procs > 1
        self.is_chief = self.proc_id == 0  # the file-writing process
        sharded = self.multi_process or cfg.data_parallel
        if sharded and (devices is not None or not self.multi_process):
            self.devices = make_mesh(devices, device)
        else:
            self.devices = [indexed(device)]
        self.device = self.devices[0]
        self.make_env = make_env or make_env_factory(cfg)
        self.results_dir = os.path.join(cfg.results_dir, cfg.run_id)
        if self.is_chief:
            os.makedirs(self.results_dir, exist_ok=True)
        self.metrics = {"steps": [], "rewards": [], "Qs": [],
                        "best_avg_reward": -float("inf")}
        self.timer = Timer()
        # Per-rank env slice (JAX train.py:506-530): cfg.num_envs counts
        # the envs of every process.
        if self.multi_process:
            if cfg.num_envs % self.num_procs:
                raise ValueError(f"num_envs {cfg.num_envs} must divide over "
                                 f"{self.num_procs} processes")
            if cfg.delta_uploads:
                raise ValueError("delta_uploads is a single-process mode")
        self.envs_local = cfg.num_envs // self.num_procs
        # Ring-capacity guard (JAX train.py:516-528): each env's ring must
        # hold one full (-history+1 .. +n) window beyond the write-head
        # exclusion zone, or the masked sampler has no valid mass.
        min_cap = 2 * (cfg.history_length + cfg.multi_step) + 2
        if cfg.capacity_per_env < min_cap:
            raise ValueError(
                f"capacity_per_env={cfg.capacity_per_env} "
                f"(memory_capacity {cfg.memory_capacity} / num_envs "
                f"{cfg.num_envs}) is below the minimum {min_cap} for "
                f"history={cfg.history_length}, n={cfg.multi_step}; raise "
                f"memory_capacity or lower num_envs")
        self.env = self.make_env(num_envs=self.envs_local, training=True,
                                 seed_offset=self.proc_id * 7919)
        self.action_space = self.env.action_space
        self.agent = ag.init_agent(cfg, self.action_space, cfg.seed,
                                   self.device)
        if cfg.model_path:  # pretrained weights (reference agent.py:26-36)
            from rainbow_tpu_torch.utils import torch_import as tim
            params = (tim.load_jax_params(cfg.model_path, cfg,
                                          self.action_space, self.device)
                      if tim.is_jax_checkpoint(cfg.model_path)
                      else ckpt.load_params(cfg.model_path, self.device))
            for k, v in params.items():
                self.agent.params[k].copy_(v)
                self.agent.target_params[k].copy_(v)
            log(f"Loaded pretrained model: {cfg.model_path}")
        # Evaluation's ε-greedy draws: a stream of its own, saved with the
        # agent's.
        self.eval_generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed + 2)
        # A replica of the agent and a replay shard per device (JAX
        # train.py:556-598); the replicas share one noise stream.
        if self.envs_local % len(self.devices):
            raise ValueError(f"num_envs {cfg.num_envs} must divide over "
                             f"{self.num_procs * len(self.devices)} devices")
        self.envs_per_shard = self.envs_local // len(self.devices)
        self.shards = Shards(self.devices, cfg, group=sharded)
        self.agents = replicate(self.agent, self.devices)
        self.reps = [rp.init_replay(self.envs_per_shard, cfg.capacity_per_env,
                                    cfg.frame_size, d) for d in self.devices]
        self.rep = self.reps[0]  # the replay, or the first shard
        self.T = 0  # env steps taken (reference's T, in agent steps)
        # Learn cadence (JAX train.py:544-552).
        if cfg.num_envs >= cfg.replay_frequency:
            self.learns_per_iter = cfg.num_envs // cfg.replay_frequency
            self.iters_per_learn = 1
        else:
            self.learns_per_iter = 1
            self.iters_per_learn = cfg.replay_frequency // cfg.num_envs
        self.beta_rate = ((1.0 - cfg.priority_weight)
                          / max(cfg.total_steps - cfg.learn_start, 1))
        self._last_loss = None
        self._use_delta = (cfg.delta_uploads and not sharded
                           and hasattr(self.env, "step_delta"))
        # Iterations by upload form: a delta, or dense (no delta uploads, or
        # the engine's dense fallback for a near-dense step).
        self.upload_forms = {"delta": 0, "dense": 0}
        self._settle_q = collections.deque()
        self._eval_pool = None
        self._eval_skipped_since = None

    # ---- persistence ----------------------------------------------------
    def _full_state(self, include_replay: bool) -> dict:
        a, opt = self.agent, self.agent.opt_state
        st = {"agent": {"params": a.params, "target_params": a.target_params,
                        "opt_state": {"mu": opt.mu, "nu": opt.nu,
                                      "count": opt.count},
                        "generator": a.generator, "step": a.step,
                        "noise": {"seed": a.noise.seed,
                                  "offset": a.noise.offset}},
              "eval_generator": self.eval_generator, "T": self.T,
              "metrics_json": np.frombuffer(json.dumps(self.metrics).encode(),
                                            np.uint8)}
        if include_replay:  # the shards' env rows in order, as one ring
            st["replay"] = {f.name: getattr(self.rep, f.name)  # no copies
                            if len(self.reps) == 1 or getattr(
                                self.rep, f.name).dim() == 0
                            else torch.cat([getattr(r, f.name).cpu()
                                            for r in self.reps])
                            for f in dataclasses.fields(self.rep)}
        return st

    def _ckpt_path(self, name: str) -> str:
        """A rank of a multi-process run writes a file of its own (its
        replay shard lives only there), JAX train.py:617-622."""
        if self.multi_process:
            name += f".proc{self.proc_id}-of-{self.num_procs}"
        return os.path.join(self.results_dir, name)

    def save_checkpoint(self, name="checkpoint.npz", include_replay=None):
        if include_replay is None:
            include_replay = self.cfg.memory_path is not None
        ckpt.save_state(self._ckpt_path(name),
                        self._full_state(include_replay),
                        compress=include_replay and self.cfg.compress_memory)

    def restore_checkpoint(self, path: str):
        """Restore a checkpoint written by save_checkpoint, in place: params,
        target, Adam state, the generators and the noise stream, T, metrics
        and, if it holds one, the replay; into every replica and replay
        shard. A rank of a multi-process run passes the base path and loads
        its own file (JAX train.py:624-649), or, without one, the base file,
        taking its own env rows of the ring."""
        if self.multi_process:
            own = f"{path}.proc{self.proc_id}-of-{self.num_procs}"
            if os.path.exists(own):
                path = own
        st = ckpt.load_state(path)
        sa = st["agent"]
        noise = NoiseStream(int(sa["noise"]["seed"]),
                            int(sa["noise"]["offset"]))
        for a in self.agents:
            for dst, src in ((a.params, sa["params"]),
                             (a.target_params, sa["target_params"]),
                             (a.opt_state.mu, sa["opt_state"]["mu"]),
                             (a.opt_state.nu, sa["opt_state"]["nu"])):
                for k, v in dst.items():
                    v.copy_(src[k])
            a.opt_state.count.copy_(sa["opt_state"]["count"])
            a.step = int(sa["step"])
            a.generator.set_state(sa["generator"].get_state())
            a.noise = noise
        self.eval_generator.set_state(st["eval_generator"].get_state())
        n = self.envs_per_shard
        for k, v in st.get("replay", {}).items():
            # This process's rows, or its slice of a ring of every env (a
            # single-process checkpoint restored into a rank).
            first = (self.proc_id * self.envs_local
                     if v.dim() and v.shape[0] == self.cfg.num_envs else 0)
            for s, rep in enumerate(self.reps):
                dst = getattr(rep, k)
                dst.copy_(v[first + s * n:first + (s + 1) * n] if dst.dim()
                          else v)
        self.T = int(st["T"])
        self.metrics = json.loads(st["metrics_json"].tobytes().decode())
        log(f"Restored checkpoint at T={self.T} from {path}")

    # ---- evaluation -----------------------------------------------------
    def _eval_env_factory(self):
        return lambda num_envs, training: self.make_env(
            num_envs=num_envs, training=training, seed_offset=1234)

    def build_validation_states(self) -> torch.Tensor:
        from rainbow_tpu_torch import evaluate as ev
        return ev.build_validation_states(
            self.cfg, lambda num_envs, training: self.make_env(
                num_envs=num_envs, training=training, seed_offset=4321),
            self.device)

    def evaluate_now(self, val_states, evaluate_only=False):
        """Evaluate the current policy (episodes + validation Q); unless
        ``evaluate_only``, record it (JAX train.py:671-732). Under more than
        one process only rank 0 evaluates, and broadcasts the episodes'
        rewards and the Q values, so every rank records the same
        metrics."""
        from rainbow_tpu_torch import evaluate as ev
        if self.is_chief:
            avg_r, avg_q, rewards, qs = ev.evaluate(
                self.cfg, self.agent.params, self.action_space,
                self._eval_env_factory(), val_states, self.eval_generator)
        if self.multi_process:
            n_ep = self.cfg.evaluation_episodes
            got = broadcast_floats(rewards + qs if self.is_chief else (),
                                   n_ep + int(val_states.shape[0]),
                                   self.device)
            rewards, qs = got[:n_ep], got[n_ep:]
            avg_r, avg_q = float(np.mean(rewards)), float(np.mean(qs))
        if not evaluate_only:
            self._apply_eval_result(self.T, self.agent.params, avg_r, avg_q,
                                    rewards, qs)
        return avg_r, avg_q

    def _apply_eval_result(self, T, params, avg_r, avg_q, rewards, qs):
        """Record one evaluation's metrics and artifacts (reference
        test.py:42-55)."""
        self.metrics["steps"].append(T)
        self.metrics["rewards"].append(rewards)
        self.metrics["Qs"].append(qs)
        best = avg_r > self.metrics["best_avg_reward"]
        if best:
            self.metrics["best_avg_reward"] = avg_r
        if not self.is_chief:
            return
        if best:  # best save, test.py:43-46
            ckpt.save_params(os.path.join(self.results_dir, "model.npz"),
                             params)
        with open(os.path.join(self.results_dir, "metrics.json"), "w") as f:
            json.dump(self.metrics, f)
        plot_line(self.metrics["steps"], self.metrics["rewards"], "Reward",
                  self.results_dir)
        plot_line(self.metrics["steps"], self.metrics["Qs"], "Q",
                  self.results_dir)

    # ---- asynchronous evaluation ----------------------------------------
    def _eval_async_start(self, val_states, force=False):
        """Schedule an evaluation of the params as they are at this T on the
        eval workers (JAX train.py:741-802): the snapshot is a copy made on
        the training stream, so it holds this iteration's updates and none
        of the next; the job runs on a CUDA stream of its own, after an
        event that orders it behind the copy. When cfg.max_pending_evals
        snapshots already wait for a worker, the evaluation is skipped and
        recorded in metrics['skipped_evals'], unless ``force``."""
        from rainbow_tpu_torch import evaluate as ev
        cfg = self.cfg
        workers = max(int(cfg.eval_workers), 1)
        if self._eval_pool is None:
            self._eval_pool = ThreadPoolExecutor(workers)
            self._eval_results = queue.Queue()
            self._eval_futs = []
            self._eval_seq_next = 0     # next seq to submit
            self._eval_seq_apply = 0    # next seq to apply
            self._eval_done = {}        # seq -> result tuple, or None
            self._eval_stream = (torch.cuda.Stream(self.device)
                                 if self.device.type == "cuda" else None)
        self._eval_futs = [f for f in self._eval_futs if not f.done()]
        pending = len(self._eval_futs)
        waiting = max(0, pending - workers)
        if not force and pending > 0 and \
                waiting >= max(cfg.max_pending_evals, 0):
            self._eval_skipped_since = self.T
            self.metrics.setdefault("skipped_evals", []).append(self.T)
            log(f"T = {self.T} | evaluation skipped ({pending} already in "
                "flight; interval shorter than eval wall time)")
            return
        self._eval_skipped_since = None
        T, seq, stream = self.T, self._eval_seq_next, self._eval_stream
        self._eval_seq_next += 1
        params = {k: v.clone() for k, v in self.agent.params.items()}
        # The job's ε-greedy stream, its own (JAX splits a key per job),
        # made from the eval generator's seed and T without a device sync.
        gen = torch.Generator(device=self.device).manual_seed(
            (self.eval_generator.initial_seed() + T * 0x9E3779B97F4A7C15)
            % 2 ** 63)
        copied = None
        if stream is not None:
            copied = torch.cuda.Event()
            copied.record()

        def job():
            try:
                with torch.cuda.stream(stream):  # no-op without a stream
                    if stream is not None:
                        stream.wait_event(copied)
                        for v in params.values():
                            v.record_stream(stream)
                    result = ev.evaluate(cfg, params, self.action_space,
                                         self._eval_env_factory(),
                                         val_states, gen)
                self._eval_results.put((seq, (T, params, *result)))
            except Exception as e:  # surface, don't stop training
                log(f"async eval at T={T} failed: {e!r}")
                self._eval_results.put((seq, None))  # keep the order moving

        self._eval_futs.append(self._eval_pool.submit(job))

    def _eval_async_drain(self, wait=False):
        """Apply finished evaluations strictly in submission order (JAX
        train.py:804-827); with ``wait``, wait for all of them first. A
        failed one leaves a None placeholder and is passed over."""
        if self._eval_pool is None:
            return
        if wait:
            for f in self._eval_futs:
                f.result()
            self._eval_futs.clear()
        while not self._eval_results.empty():
            seq, res = self._eval_results.get()
            self._eval_done[seq] = res
        while self._eval_seq_apply in self._eval_done:
            res = self._eval_done.pop(self._eval_seq_apply)
            self._eval_seq_apply += 1
            if res is None:
                continue
            T, params, avg_r, avg_q, rewards, qs = res
            self._apply_eval_result(T, params, avg_r, avg_q, rewards, qs)
            log(f"T = {T} / {self.cfg.total_steps} | Avg. reward: {avg_r} | "
                f"Avg. Q: {avg_q:.4f} | {self.timer.summary()}")

    # ---- staging --------------------------------------------------------
    def _stage(self, acts_np, stream=None):
        """Step the engine with ``acts_np``, pack the step on the host and
        upload it (JAX train.py:914-951): returns (is_delta, tails, event),
        ``tails`` one tuple of device tensors per shard, its rows of the
        step: what actor_step_delta (a delta, one shard) or
        actor_step_packed (dense: no delta uploads, or the engine's dense
        fallback) take after prev_actions. With a CUDA ``stream`` (the
        pipelined worker's), the upload goes through pinned memory on that
        stream without blocking, and ``event`` marks its end; else it is a
        plain copy on the current stream and ``event`` is None. Shards off
        the stream's device take plain copies."""
        with self.timer.span("engine"):
            if self._use_delta:
                counts, dpos, dval, *rest = self.env.step_delta(acts_np)
                obs_form = ((dpos,) if counts is None
                            else (delta_offsets(counts), dpos, dval))
            else:
                obs, *rest = self.env.step(acts_np)
                obs_form = (obs,)
        with self.timer.span("upload"):
            n = self.envs_per_shard
            hosts = ([_host_step(obs_form, *rest)] if len(self.devices) == 1
                     else [_host_step((obs[s * n:(s + 1) * n],),
                                      *(x[s * n:(s + 1) * n] for x in rest))
                           for s in range(len(self.devices))])
            tails = []
            for host, dev in zip(hosts, self.devices):
                if stream is None or dev != stream.device:
                    tails.append(tuple(torch.from_numpy(a).to(dev)
                                       for a in host))
                    continue
                with torch.cuda.stream(stream):
                    # The engine's buffers are rewritten two steps on: the
                    # copies into pinned memory finish here, on this thread.
                    tails.append(tuple(torch.from_numpy(a).pin_memory().to(
                        dev, non_blocking=True) for a in host))
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
        return len(obs_form) == 3, tails, done

    def _launch(self, staged, stacks, prev_actions, num_learns, beta,
                sync_target, act_noise):
        """Launch one training iteration on the staged step over the shards'
        stacks; returns the actions (N_local,) int64 on the first device."""
        with self.timer.span("launch"):
            is_delta, tails, done = staged
            if done is not None:  # the upload ran on the worker's stream
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                for t in sum(tails, ()):
                    if t.device == self.device:
                        t.record_stream(cur)
            self.upload_forms["delta" if is_delta else "dense"] += 1
            if is_delta:  # one shard: the delta kernel rebuilds its frames
                (offsets, pos, val, *rest), = tails
                tails = [(apply_delta(stacks[0], offsets, pos, val), *rest)]
            actions, loss = train_iter_sharded(
                self.cfg, self.action_space, num_learns, self.agents, stacks,
                self.reps, self.shards, prev_actions, tails, np.float32(beta),
                bool(sync_target), act_noise)
            if num_learns:  # a device scalar, fetched by the heartbeat
                self._last_loss = loss
        return actions

    def _fetch(self, pool, actions):
        """A future of ``actions`` as a numpy array. On the card the copy
        goes to pinned memory without blocking and the pool's thread waits
        for its event only, not for the learner launched after it."""
        if not actions.is_cuda:
            return pool.submit(actions.numpy)
        host = torch.empty(actions.shape, dtype=actions.dtype,
                           pin_memory=True)
        host.copy_(actions, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return pool.submit(lambda: (done.synchronize(), host.numpy())[1])

    def _settle(self):
        """Bound the iterations in flight to cfg.settle_window: mark this
        one's end and wait for the one that many back (JAX
        train.py:1084-1100)."""
        mark = None
        if self.device.type == "cuda":
            mark = torch.cuda.Event()
            mark.record()
        self._settle_q.append(mark)
        if len(self._settle_q) > max(self.cfg.settle_window, 0):
            oldest = self._settle_q.popleft()
            if oldest is not None:
                with self.timer.span("device_wait"):
                    oldest.synchronize()

    # ---- main loop ------------------------------------------------------
    def _draw_act_noise(self) -> dict:
        """A fresh act-noise draw: one per env row with cfg.per_env_noise,
        else one shared by all rows."""
        lead = (self.cfg.num_envs,) if self.cfg.per_env_noise else ()
        return ag.reset_noise(self.agent, self.cfg, self.action_space, lead)

    def run(self):
        """Train until T reaches cfg.total_steps (JAX train.py:829-1165, the
        single-device branches); returns the metrics."""
        cfg = self.cfg
        log("Building validation memory")
        val_states = self.build_validation_states()
        frames, n = self.env.reset_all(), self.envs_per_shard
        # A stack per shard (its env rows).
        stacks = [init_framestack(n, cfg.history_length,
                                 frames[s * n:(s + 1) * n], d)
                 for s, d in enumerate(self.devices)]
        # The act noise is held between redraws, as JAX's act reuses
        # agent.noise_key until reset_noise (train.py:262, 1042-1051). This
        # first act, on this thread, also compiles the head kernel's variant
        # that an asynchronous evaluation launches.
        act_noise = self._draw_act_noise()
        actions = act_sharded(self.agents, cfg, self.action_space, stacks,
                              self.shards, act_noise)
        pipelined = cfg.pipeline_actor
        if pipelined:
            # A depth-D action queue, seeded with D copies of the first
            # actions (a start-up transient; the lag settles to D steps),
            # and their fetches; the worker steps the engine with them.
            pool, fetch_pool = ThreadPoolExecutor(1), ThreadPoolExecutor(3)
            stage_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)
            action_queue = collections.deque(
                [actions] * max(cfg.pipeline_depth, 1))
            pending_a = action_queue.popleft()
            action_queue.append(pending_a)
            fetch_q = collections.deque(self._fetch(fetch_pool, a)
                                        for a in action_queue)
            fut = pool.submit(self._stage, pending_a.cpu().numpy(),
                              stage_stream)
        else:
            acts_np = actions.cpu().numpy()
        it = 0
        # Schedule marks relative to the current T (exact after a resume).
        nxt = lambda interval: ((self.T // interval) + 1) * interval \
            if interval else float("inf")
        next_target_sync = nxt(cfg.target_update)
        next_eval = nxt(cfg.evaluation_interval)
        next_ckpt = nxt(cfg.checkpoint_interval)
        # Replay-bearing saves: coupled to every eval (reference
        # main.py:172-174) or on their own interval.
        next_memsave = nxt(cfg.memory_save_interval) \
            if cfg.memory_path is not None else float("inf")
        prof, timer = None, self.timer
        last_log_t, last_log_T = time.time(), self.T
        while self.T < cfg.total_steps:
            now = time.time()
            if now - last_log_t > 60 and self.is_chief:  # heartbeat
                sps = (self.T - last_log_T) / (now - last_log_t)
                loss_s = ("" if self._last_loss is None
                          else f" | loss: {float(self._last_loss):.4f}")
                log(f"T = {self.T} | {sps:.0f} env-steps/s{loss_s} | "
                    f"{self.timer.summary()}")
                last_log_t, last_log_T = now, self.T
            it += 1
            if cfg.profile and self.is_chief:  # a steady-state window
                if it == 20:
                    prof = self._start_profile()
                elif it == 40 and prof is not None:
                    self._stop_profile(prof)
                    prof = None
            self.T += cfg.num_envs
            learning = self.T >= cfg.learn_start
            do_learn = learning and it % self.iters_per_learn == 0
            num_learns = self.learns_per_iter if do_learn else 0
            beta = min(1.0, cfg.priority_weight
                       + (self.T - cfg.learn_start) * self.beta_rate) \
                if learning else 0.0
            sync_target = do_learn and self.T >= next_target_sync
            if do_learn or (not learning
                            and it % self.iters_per_learn == 0):
                # Redrawn before every learning round and, in warm-up, every
                # replay_frequency env-steps (reference main.py:150-151).
                act_noise = self._draw_act_noise()

            if pipelined:
                with timer.span("env"):
                    staged = fut.result()  # step t, staged by the worker
                a_exec = pending_a  # the actions step t executed
                pending_a = action_queue.popleft()
                with timer.span("fetch"), timer.span("device_wait"):
                    pa_np = fetch_q.popleft().result()  # fetched D iters ago
                fut = pool.submit(self._stage, pa_np, stage_stream)  # t+1
                with timer.span("actor"):
                    a_new = self._launch(staged, stacks, a_exec, num_learns,
                                         beta, sync_target, act_noise)
                    action_queue.append(a_new)
                    fetch_q.append(self._fetch(fetch_pool, a_new))
                with timer.span("settle"):
                    self._settle()
            else:
                with timer.span("env"):
                    staged = self._stage(acts_np)
                with timer.span("actor"):
                    actions = self._launch(staged, stacks, actions,
                                           num_learns, beta, sync_target,
                                           act_noise)
                    with timer.span("device_wait"):
                        acts_np = actions.cpu().numpy()
            if learning:
                if self.T >= next_target_sync:  # main.py:177-178
                    if not sync_target:  # else synced inside the iteration
                        for agent in self.agents:
                            ag.update_target(agent)
                    next_target_sync += cfg.target_update
                if self.T >= next_eval:  # main.py:166-174
                    if cfg.async_eval and not self.multi_process:
                        self._eval_async_start(val_states)
                    else:
                        avg_r, avg_q = self.evaluate_now(val_states)
                        if self.is_chief:
                            log(f"T = {self.T} / {cfg.total_steps} | Avg. "
                                f"reward: {avg_r} | Avg. Q: {avg_q:.4f} | "
                                f"{self.timer.summary()}")
                    next_eval += cfg.evaluation_interval
                    if (cfg.memory_path is not None
                            and not cfg.memory_save_interval):
                        self.save_checkpoint("memory_checkpoint.npz",
                                             include_replay=True)
                self._eval_async_drain()
                if self.T >= next_memsave:  # decoupled replay-save cadence
                    self.save_checkpoint("memory_checkpoint.npz",
                                         include_replay=True)
                    next_memsave += cfg.memory_save_interval
                if self.T >= next_ckpt:  # main.py:181-182
                    self.save_checkpoint()
                    next_ckpt += cfg.checkpoint_interval
        if prof is not None:
            self._stop_profile(prof)
        if pipelined:
            fut.result()  # the engine step in flight, before the close
            for f in fetch_q:
                f.result()
            pool.shutdown()
            fetch_pool.shutdown()
        if self._eval_skipped_since is not None:
            # Coalescing skipped an evaluation since the last one ran: a
            # forced final one measures the end-of-training policy (the
            # reference's last evaluation lands at T_max, main.py:166).
            self._eval_async_start(val_states, force=True)
        self._eval_async_drain(wait=True)
        if self._eval_pool is not None:
            self._eval_pool.shutdown()
        self.env.close()
        return self.metrics

    def _start_profile(self):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # Every thread's ranges: the pipelined worker's spans too.
        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        out = os.path.join(self.results_dir, "trace")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        log(f"Profiler trace written to {out}")
