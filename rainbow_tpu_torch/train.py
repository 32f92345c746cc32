"""The batched actor's per-iteration step, the batched-PER learner round,
the fused training iteration and the Trainer (rainbow_tpu/train.py:45-138,
230-296, 351-418, 451-1165).

One actor iteration appends the transition that just ended to the replay,
advances the frame stack (one launch of the append + frame-stack kernel on
CUDA) and selects every env's next action in one forward. A training
iteration runs a learner round first, against the replay as it was before
this iteration's append, then the masked target sync, then the actor
iteration. The stack, the replay and the agent are updated in place (the
JAX package donates them instead); only the caller's fetch of the actions
waits for the device. The Trainer schedules those iterations: the learn
cadence, β, the target sync, evaluation and checkpoints.

Random draws come from the agent's generator. A caller that must match
draws made elsewhere (the tests, which replay the JAX package's) passes
them in ``draws``: ``"u"`` the round's stratified uniforms, ``"target"``
the target forward's per-row noise, ``"online"`` the per-update online
noise (models.dqn.draw_noise with lead (num_learns,)), ``"act"`` the act
forward's noise. The Trainer passes ``"act"`` itself, to hold the act noise
between redraws as the JAX package's Trainer does.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch import checkpoint as ckpt
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.models.dqn import draw_noise, forward_head
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
    rp.update_priorities(rep, big["idxs"], losses, cfg.priority_exponent)
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


_UNPORTED = (  # (config flag, the ROADMAP item that ports it)
    ("sequential_per", "Queue 1 item 11, the sequential PER round"),
    ("pipeline_actor", "Queue 1 item 11, the pipelined actor"),
    ("async_eval", "Queue 1 item 11, async evaluation"),
    ("delta_uploads", "Queue 1 item 11, delta uploads with kernel K10"),
    ("data_parallel", "Queue 1 item 12, data-parallel training"),
)


class Trainer:
    """The training loop of one process on one device (JAX train.py:466-1165
    without its side paths): the learn cadence, β annealing, the target
    sync, evaluation with the best-model save, metrics and plots, and
    atomic checkpoints, around one ``train_iter_packed`` per iteration.
    Host-side scheduling only; every iteration's device work is queued by
    ``train_iter_packed`` and the one wait is the fetch of the actions."""

    def __init__(self, cfg: RainbowConfig,
                 make_env: Optional[Callable] = None, device="cuda"):
        for flag, item in _UNPORTED:
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f"Trainer: cfg.{flag} is not ported yet ({item} in "
                    "ROADMAP.md)")
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

    # ---- persistence ----------------------------------------------------
    def _full_state(self, include_replay: bool) -> dict:
        a, opt = self.agent, self.agent.opt_state
        st = {"agent": {"params": a.params, "target_params": a.target_params,
                        "opt_state": {"mu": opt.mu, "nu": opt.nu,
                                      "count": opt.count},
                        "generator": a.generator, "step": a.step},
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
        target, Adam state, the generators, T, metrics and, if it holds
        one, the replay."""
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

    # ---- main loop ------------------------------------------------------
    def _draw_act_noise(self) -> dict:
        """A fresh act-noise draw: one per env row with cfg.per_env_noise,
        else one shared by all rows."""
        lead = (self.cfg.num_envs,) if self.cfg.per_env_noise else ()
        return draw_noise(self.cfg, self.action_space, self.agent.generator,
                          lead, self.device)

    def run(self):
        """Train until T reaches cfg.total_steps (JAX train.py:829-1165, the
        non-pipelined single-device branch); returns the metrics."""
        cfg = self.cfg
        log("Building validation memory")
        val_states = self.build_validation_states()
        stack = init_framestack(cfg.num_envs, cfg.history_length,
                                self.env.reset_all(), self.device)
        # The act noise is held between redraws, as JAX's act reuses
        # agent.noise_key until reset_noise (train.py:262, 1042-1051).
        act_noise = self._draw_act_noise()
        actions = ag.act(self.agent.params, cfg, self.action_space,
                         to_network_input(stack), None, act_noise)
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

            self.timer.start("env")
            staged = stage_step(self.env.step(acts_np), self.device)
            self.timer.stop("env")
            self.timer.start("actor")
            actions, loss = train_iter_packed(
                cfg, self.action_space, num_learns, self.agent, stack,
                self.rep, actions, *staged, np.float32(beta),
                bool(sync_target), {"act": act_noise})
            if num_learns:  # a device scalar, fetched by the heartbeat
                self._last_loss = loss
            acts_np = actions.cpu().numpy()
            self.timer.stop("actor")
            if learning:
                if self.T >= next_target_sync:  # main.py:177-178
                    if not sync_target:  # else synced inside the iteration
                        ag.update_target(self.agent)
                    next_target_sync += cfg.target_update
                if self.T >= next_eval:  # main.py:166-174
                    avg_r, avg_q = self.evaluate_now(val_states)
                    log(f"T = {self.T} / {cfg.total_steps} | Avg. reward: "
                        f"{avg_r} | Avg. Q: {avg_q:.4f} | "
                        f"{self.timer.summary()}")
                    next_eval += cfg.evaluation_interval
                    if (cfg.memory_path is not None
                            and not cfg.memory_save_interval):
                        self.save_checkpoint("memory_checkpoint.npz",
                                             include_replay=True)
                if self.T >= next_memsave:  # decoupled replay-save cadence
                    self.save_checkpoint("memory_checkpoint.npz",
                                         include_replay=True)
                    next_memsave += cfg.memory_save_interval
                if self.T >= next_ckpt:  # main.py:181-182
                    self.save_checkpoint()
                    next_ckpt += cfg.checkpoint_interval
        if prof is not None:
            self._stop_profile(prof)
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
