"""The batched actor's per-iteration step, the learner rounds (batched and
sequential PER), the fused training iteration with dense or delta
observations, and the Trainer (rainbow_tpu/train.py:45-316, 351-448,
451-1165).

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
``"act"`` the act forward's noise. The Trainer passes ``"act"`` itself, to
hold the act noise between redraws as the JAX package's Trainer does.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch import checkpoint as ckpt
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.envs.engine import delta_bucket
from rainbow_tpu_torch.kernels import delta as k10
from rainbow_tpu_torch.models.dqn import draw_noise_sets, forward_head
from rainbow_tpu_torch.models.noisy import NoiseStream
from rainbow_tpu_torch.ops.preprocess import (append_framestack,
                                              init_framestack,
                                              to_network_input)
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch.utils.logging import Timer, log
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
    the sequential PER round with cfg.sequential_per, else the batched one.
    Updates ``agent`` and ``rep.priorities``/``max_priority`` in place;
    returns the mean loss as a 0-d device tensor."""
    impl = _learner_round_impl if cfg.sequential_per \
        else _learner_round_batched_impl
    return impl(agent, rep, cfg, action_space, num_learns, beta, draws)


def _learner_round_batched_impl(agent: ag.AgentState, rep: rp.ReplayState,
                                cfg: RainbowConfig, action_space: int,
                                num_learns: int, beta,
                                draws: Optional[dict] = None) -> torch.Tensor:
    """The batched-PER learner round (JAX train.py:351-418): one stratified
    draw of all ``num_learns`` batches against the round-start priorities,
    one windowed gather, one target-net forward over all of the round's
    rows with per-row noise, then per update the double-Q target, the
    gradient and clip + Adam with the online noise of that update (one draw
    shared over its batch), and one priority write-back at the end. The
    target and online noise are one draw of the noise stream."""
    draws = draws or {}
    nb, bs = num_learns, cfg.batch_size
    big = rp.sample_many(rep, beta, num_batches=nb, batch_size=bs,
                         history=cfg.history_length, n_step=cfg.multi_step,
                         discount=cfg.discount, generator=agent.generator,
                         u=draws.get("u"))
    dev = big["weights"].device
    ns_flat = rp.states_to_float(
        big["next_states"].reshape((nb * bs,) + big["next_states"].shape[2:]))
    target_eps, online = draws.get("target"), draws.get("online")
    if target_eps is None or online is None:
        target_eps, online = draw_noise_sets(cfg, action_space, agent.noise,
                                             [(nb * bs,), (nb,)], dev)
    with torch.no_grad():
        pns_target = forward_head(agent.target_params, cfg, action_space,
                                  ns_flat, dist="probs",
                                  noise_eps=target_eps).dist
    del ns_flat
    pns_target = pns_target.view(nb, bs, action_space, cfg.atoms)
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
    rp.update_priorities(rep, big["idxs"], losses, cfg.priority_exponent)
    return losses.mean()


def _learner_round_impl(agent: ag.AgentState, rep: rp.ReplayState,
                        cfg: RainbowConfig, action_space: int,
                        num_learns: int, beta,
                        draws: Optional[dict] = None) -> torch.Tensor:
    """The sequential PER round (JAX train.py:421-448; reference
    agent.py:61-100 per update): ``num_learns`` learn steps, each with fresh
    online noise, sampling against the priorities the previous update
    wrote, then its update, clip + Adam and its write-back. Injected draws
    carry a leading (num_learns,) axis: ``"u"`` (num_learns, B), ``"online"``
    and ``"target"`` draw_noise dicts."""
    draws = draws or {}
    losses = []
    for i in range(num_learns):
        d = {"u": draws["u"][i]} if "u" in draws else {}
        for k in ("online", "target"):
            if k in draws:
                d[k] = {n: (a[i], b[i]) for n, (a, b) in draws[k].items()}
        losses.append(ag.learn_step(agent, rep, cfg, action_space, beta, d))
    return torch.stack(losses).mean()


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
                     to_network_input(stack), agent.noise, draws.get("act"))
    return actions, loss


def train_iter_delta(cfg: RainbowConfig, action_space: int, num_learns: int,
                     agent: ag.AgentState, stack: torch.Tensor,
                     rep: rp.ReplayState, prev_actions, delta_offsets,
                     delta_pos, delta_val, reset_packed, reset_idx, rewards,
                     dones, kinds, beta, sync_target: bool,
                     draws: Optional[dict] = None):
    """train_iter_packed with the observations as a sparse delta against the
    stack's newest plane (JAX train.py:302-316): the delta kernel rebuilds
    them, then the iteration runs as train_iter_packed."""
    obs = apply_delta(stack, delta_offsets, delta_pos, delta_val)
    return train_iter_packed(cfg, action_space, num_learns, agent, stack, rep,
                             prev_actions, obs, reset_packed, reset_idx,
                             rewards, dones, kinds, beta, sync_target, draws)


class Trainer:
    """The training loop of one process on one device (JAX train.py:466-1165
    without data parallelism): the learn cadence, β annealing, the target
    sync, evaluation with the best-model save, metrics and plots, and
    atomic checkpoints, around one training iteration per step
    (``train_iter_packed``, or ``train_iter_delta`` for a delta upload).
    Host-side scheduling only; every iteration's device work is queued, and
    the waits are the fetch of the actions and, pipelined, the settle
    window.

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
                 make_env: Optional[Callable] = None, device="cuda"):
        if cfg.data_parallel:
            raise NotImplementedError(
                "Trainer: cfg.data_parallel is not ported yet (Queue 1 item "
                "12, data-parallel training, in ROADMAP.md)")
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "Trainer: multi-process training is not ported yet (Queue 1 "
                "item 12 in ROADMAP.md)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.make_env = make_env or make_env_factory(cfg)
        self.results_dir = os.path.join(cfg.results_dir, cfg.run_id)
        os.makedirs(self.results_dir, exist_ok=True)
        self.metrics = {"steps": [], "rewards": [], "Qs": [],
                        "best_avg_reward": -float("inf")}
        self.timer = Timer()
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
        self.env = self.make_env(num_envs=cfg.num_envs, training=True,
                                 seed_offset=0)
        self.action_space = self.env.action_space
        self.agent = ag.init_agent(cfg, self.action_space, cfg.seed,
                                   self.device)
        if cfg.model_path:  # pretrained weights (reference agent.py:26-36)
            params = ckpt.load_params(cfg.model_path, self.device)
            for k, v in params.items():
                self.agent.params[k].copy_(v)
                self.agent.target_params[k].copy_(v)
            log(f"Loaded pretrained model: {cfg.model_path}")
        # Evaluation's ε-greedy draws: a stream of its own, saved with the
        # agent's.
        self.eval_generator = torch.Generator(
            device=self.device).manual_seed(cfg.seed + 2)
        self.rep = rp.init_replay(cfg.num_envs, cfg.capacity_per_env,
                                  cfg.frame_size, self.device)
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
        self._use_delta = cfg.delta_uploads and hasattr(self.env,
                                                        "step_delta")
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
        if include_replay:
            st["replay"] = {f.name: getattr(self.rep, f.name)  # no copies
                            for f in dataclasses.fields(self.rep)}
        return st

    def save_checkpoint(self, name="checkpoint.npz", include_replay=None):
        if include_replay is None:
            include_replay = self.cfg.memory_path is not None
        ckpt.save_state(os.path.join(self.results_dir, name),
                        self._full_state(include_replay),
                        compress=include_replay and self.cfg.compress_memory)

    def restore_checkpoint(self, path: str):
        """Restore a checkpoint written by save_checkpoint, in place: params,
        target, Adam state, the generators and the noise stream, T, metrics
        and, if it holds one, the replay."""
        st = ckpt.load_state(path)
        a, sa = self.agent, st["agent"]
        for dst, src in ((a.params, sa["params"]),
                         (a.target_params, sa["target_params"]),
                         (a.opt_state.mu, sa["opt_state"]["mu"]),
                         (a.opt_state.nu, sa["opt_state"]["nu"])):
            for k, v in dst.items():
                v.copy_(src[k])
        a.opt_state.count.copy_(sa["opt_state"]["count"])
        a.step = int(sa["step"])
        a.generator.set_state(sa["generator"].get_state())
        a.noise = NoiseStream(int(sa["noise"]["seed"]),
                              int(sa["noise"]["offset"]))
        self.eval_generator.set_state(st["eval_generator"].get_state())
        if "replay" in st:
            for k, v in st["replay"].items():
                getattr(self.rep, k).copy_(v)
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
        ``evaluate_only``, record it (JAX train.py:671-732)."""
        from rainbow_tpu_torch import evaluate as ev
        avg_r, avg_q, rewards, qs = ev.evaluate(
            self.cfg, self.agent.params, self.action_space,
            self._eval_env_factory(), val_states, self.eval_generator)
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
        if avg_r > self.metrics["best_avg_reward"]:
            self.metrics["best_avg_reward"] = avg_r
            ckpt.save_params(os.path.join(self.results_dir, "model.npz"),
                             params)  # best save, test.py:43-46
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
        upload it (JAX train.py:914-951): returns (is_delta, tail, event),
        ``tail`` the device tensors train_iter_delta (a delta) or
        train_iter_packed (dense: no delta uploads, or the engine's dense
        fallback) take after prev_actions. With a CUDA ``stream`` (the
        pipelined worker's), the upload goes through pinned memory on that
        stream without blocking, and ``event`` marks its end; else it is a
        plain copy on the current stream and ``event`` is None."""
        if self._use_delta:
            counts, dpos, dval, *rest = self.env.step_delta(acts_np)
            obs_form = ((dpos,) if counts is None
                        else (delta_offsets(counts), dpos, dval))
        else:
            obs, *rest = self.env.step(acts_np)
            obs_form = (obs,)
        host = _host_step(obs_form, *rest)
        if stream is None:
            return len(obs_form) == 3, tuple(
                torch.from_numpy(a).to(self.device) for a in host), None
        with torch.cuda.stream(stream):
            # The engine's buffers are rewritten two steps on: the copies
            # into pinned memory finish here, on this thread.
            tail = tuple(torch.from_numpy(a).pin_memory().to(
                self.device, non_blocking=True) for a in host)
            done = torch.cuda.Event()
            done.record(stream)
        return len(obs_form) == 3, tail, done

    def _launch(self, staged, stack, prev_actions, num_learns, beta,
                sync_target, act_noise):
        """Launch one training iteration on the staged step; returns the
        actions (N,) int64 on the device."""
        is_delta, tail, done = staged
        if done is not None:  # the upload ran on the worker's stream
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in tail:
                t.record_stream(cur)
        self.upload_forms["delta" if is_delta else "dense"] += 1
        fn = train_iter_delta if is_delta else train_iter_packed
        actions, loss = fn(self.cfg, self.action_space, num_learns,
                           self.agent, stack, self.rep, prev_actions, *tail,
                           np.float32(beta), bool(sync_target),
                           {"act": act_noise})
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
        stack = init_framestack(cfg.num_envs, cfg.history_length,
                                self.env.reset_all(), self.device)
        # The act noise is held between redraws, as JAX's act reuses
        # agent.noise_key until reset_noise (train.py:262, 1042-1051). This
        # first act, on this thread, also compiles the head kernel's variant
        # that an asynchronous evaluation launches.
        act_noise = self._draw_act_noise()
        actions = ag.act(self.agent.params, cfg, self.action_space,
                         to_network_input(stack), None, act_noise)
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
        prof = None
        last_log_t, last_log_T = time.time(), self.T
        while self.T < cfg.total_steps:
            now = time.time()
            if now - last_log_t > 60:  # throughput heartbeat
                sps = (self.T - last_log_T) / (now - last_log_t)
                loss_s = ("" if self._last_loss is None
                          else f" | loss: {float(self._last_loss):.4f}")
                log(f"T = {self.T} | {sps:.0f} env-steps/s{loss_s} | "
                    f"{self.timer.summary()}")
                last_log_t, last_log_T = now, self.T
            it += 1
            if cfg.profile:  # trace a steady-state window
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
                self.timer.start("env")
                staged = fut.result()  # step t, staged by the worker
                self.timer.stop("env")
                a_exec = pending_a  # the actions step t executed
                pending_a = action_queue.popleft()
                self.timer.start("fetch")
                pa_np = fetch_q.popleft().result()  # fetched D iters ago
                self.timer.stop("fetch")
                fut = pool.submit(self._stage, pa_np, stage_stream)  # t+1
                self.timer.start("actor")
                a_new = self._launch(staged, stack, a_exec, num_learns, beta,
                                     sync_target, act_noise)
                action_queue.append(a_new)
                fetch_q.append(self._fetch(fetch_pool, a_new))
                self.timer.stop("actor")
                self.timer.start("settle")
                self._settle()
                self.timer.stop("settle")
            else:
                self.timer.start("env")
                staged = self._stage(acts_np)
                self.timer.stop("env")
                self.timer.start("actor")
                actions = self._launch(staged, stack, actions, num_learns,
                                       beta, sync_target, act_noise)
                acts_np = actions.cpu().numpy()
                self.timer.stop("actor")
            if learning:
                if self.T >= next_target_sync:  # main.py:177-178
                    if not sync_target:  # else synced inside the iteration
                        ag.update_target(self.agent)
                    next_target_sync += cfg.target_update
                if self.T >= next_eval:  # main.py:166-174
                    if cfg.async_eval:
                        self._eval_async_start(val_states)
                    else:
                        avg_r, avg_q = self.evaluate_now(val_states)
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
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
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
