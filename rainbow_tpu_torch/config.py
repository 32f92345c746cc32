"""Typed configuration for rainbow-tpu.

Replaces the reference's 31 argparse flags (reference main.py:21-61) with a
frozen dataclass whose defaults encode the canonical Rainbow hyperparameters,
plus the data-efficient (Atari-100k) preset from reference README.md:25-36 as
a first-class constructor. New TPU-native knobs (num_envs, mesh axes, dtype)
have no reference equivalent — the reference is strictly single-env,
single-device (SURVEY.md §2 "Parallelism").
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RainbowConfig:
    # Experiment
    run_id: str = "default"            # reference main.py:22 --id
    seed: int = 123                    # reference main.py:23 --seed
    game: str = "pong"                 # reference main.py:25 --game
    results_dir: str = "results"

    # Budget / schedule
    total_steps: int = int(50e6)       # reference main.py:26 --T-max (agent steps)
    max_episode_length: int = int(108e3)  # reference main.py:27 (game frames)
    learn_start: int = int(20e3)       # reference main.py:48 --learn-start
    replay_frequency: int = 4          # reference main.py:36 --replay-frequency
    target_update: int = int(8e3)      # reference main.py:41 --target-update
    checkpoint_interval: int = 0       # reference main.py:56

    # Observation
    history_length: int = 4            # reference main.py:28
    frame_size: int = 84               # implied, reference env.py:28

    # Network
    architecture: str = "canonical"    # reference main.py:29; or 'impala-x4'
    hidden_size: int = 512             # reference main.py:30
    noisy_std: float = 0.1             # reference main.py:31 --noisy-std (σ₀)
    atoms: int = 51                    # reference main.py:32
    v_min: float = -10.0               # reference main.py:33
    v_max: float = 10.0                # reference main.py:34

    # Replay
    memory_capacity: int = int(1e6)    # reference main.py:35 (total across envs)
    priority_exponent: float = 0.5     # reference main.py:37 (ω)
    priority_weight: float = 0.4       # reference main.py:38 (initial β)
    multi_step: int = 3                # reference main.py:39 (n)

    # Optimisation
    discount: float = 0.99             # reference main.py:40 (γ)
    reward_clip: float = 1.0           # reference main.py:42 (0 disables)
    learning_rate: float = 0.0000625   # reference main.py:43
    adam_eps: float = 1.5e-4           # reference main.py:44
    batch_size: int = 32               # reference main.py:46
    norm_clip: float = 10.0            # reference main.py:47

    # Evaluation
    evaluation_interval: int = 100_000  # reference main.py:50
    evaluation_episodes: int = 10       # reference main.py:51
    evaluation_size: int = 500          # reference main.py:53 (validation-Q states)
    eval_epsilon: float = 0.001         # reference agent.py:58

    # TPU-native knobs (no reference equivalent)
    num_envs: int = 64                 # batched-ALE engine width per host
    compute_dtype: str = "float32"     # 'float32' | 'bfloat16' network compute
    adam_mu_dtype: str = "float32"     # 'float32' | 'bfloat16' Adam FIRST
    # moment storage. The learner's HBM floor is optimizer-state traffic
    # (~196 MB/update fp32, docs/results_r3 §6); bf16 mu cuts the m-term in
    # half with β1=0.9 increments (0.1·g) comfortably above bf16 ulp. The
    # SECOND moment stays fp32 always: its (1-β2)=1e-3 increments fall below
    # bf16 ulp at steady state, so a bf16 nu would silently freeze.
    env_backend: str = "native"        # 'native' (C++ engine) | 'fake' (python fixture)
    life_every: int = 0                # fake backend: life loss every k steps (0 = never)
    per_env_noise: bool = True         # independent NoisyNet draw per env row
    # at act time — the batched-native generalisation of the reference's
    # single-env noise (its one env trivially has its own draw). Default ON
    # since round 5: with a SHARED draw, deterministic-start maze games
    # collapse the whole fleet to ~1 effective explorer (bank_heist learned
    # literally nothing in 100k steps: Q -> 0.0; with per-env noise, 640 vs
    # random 128 — docs/results_r5). Costs ~2% actor throughput at 1024
    # envs. Off = one shared noise sample for the whole act batch.
    pipeline_actor: bool = False       # overlap engine stepping with device
    # compute by accepting a 1-step policy lag (actions for step t+1 are
    # computed from state t). Off by default for strict reference parity;
    # recommended at high env counts where the lag is negligible.
    pipeline_depth: int = 1            # action-queue depth D when
    # pipeline_actor is on: actions execute D steps after the state they were
    # computed from, letting D device→host action fetches drain concurrently
    # (hides fetch RTT; essential on high-latency links). D=1 is the classic
    # 1-step lag; larger D trades policy freshness for throughput, like
    # distributed actor systems (Ape-X/IMPALA-style staleness).
    delta_uploads: bool = False        # send observations as sparse pixel
    # deltas against the device's frame-stack newest slot (engine.step_delta):
    # the device reconstructs obs with one sorted-unique scatter. Cuts the
    # per-step host→device payload to the changed pixels — the actor wall on
    # bandwidth-limited host links. Lossless; native backend only. Steps whose
    # delta exceeds ~1/5 dense size fall back to the dense upload.
    sequential_per: bool = False       # exact reference PER sequencing: every
    # update in a learner round re-samples against the LATEST priorities
    # (reference agent.py:61-100 interleaves sample/update/priority-write per
    # update). Off (default) = batched-PER rounds: one stratified sample of
    # the whole round's batches against the round-start priority snapshot,
    # one windowed gather, one priority write-back — removes the per-update
    # tree rebuild + gather + scatter chain that dominates the scanned
    # round's serial latency on TPU. Action selection, target construction
    # and Adam remain exactly per-update. Within-round priority staleness is
    # the Ape-X/distributed-PER regime; at batched env counts a "round" IS
    # one algorithm iteration.
    settle_window: int = 2             # max fused iterations in flight
    # before the loop settles the oldest one's output (device→host value
    # fetch, a real data dependency). Unbounded async dispatch collapses
    # ~3x on remote-dispatch runtimes: queueing many un-settled fused
    # programs with their uploads degrades device-side scheduling (measured
    # per identical 1024-env iteration: unbounded 1.2 s, window 1 → 0.40 s,
    # window 2 → 0.35 s). 0 is fully serial; large values restore the
    # unbounded r2 behavior. NOTE the depth-D action queue already settles
    # the program from D iterations back (its action fetch), so this knob
    # only bites when pipeline_depth > settle_window.
    data_parallel: bool = False        # shard envs/replay over all local
    # devices ('data' mesh): replicated agent, per-device replay shards,
    # psum-mean gradients (parallel/learner.py). Requires num_envs and
    # batch_size divisible by the device count.

    async_eval: bool = False           # run evaluations on a background
    # thread against a snapshot of the params instead of blocking the
    # training loop (the reference evaluates inline, main.py:166-169; at
    # batched-actor throughputs an inline eval stalls training for minutes).
    # Metrics/plots/best-model saves land when the eval finishes, tagged
    # with the step T the snapshot was taken at.
    eval_workers: int = 1              # concurrent async evaluations: >1
    # overlaps independent evals' per-step dispatch round trips on
    # RTT-bound links (results still apply in submission order). Each
    # worker holds its own eval env batch; raise for suite runs on
    # high-latency tunnels, keep 1 where eval compute itself matters.
    max_pending_evals: int = 4         # async-eval backlog bound: each
    # scheduled eval snapshots the params at its T and queues; beyond this
    # many waiting snapshots the interval is skipped instead (recorded in
    # metrics['skipped_evals']). Bounds the end-of-run drain on links where
    # one eval outlasts the eval interval, while guaranteeing short suite
    # runs keep near-full curve density (VERDICT r3 weak #4).

    # Observability
    render: bool = False               # save eval-episode frames as PNGs
    # (headless analogue of reference env.py:90-92 cv2.imshow)
    profile: bool = False              # capture a torch.profiler trace of the
    # steady-state training loop into results/<id>/trace (SURVEY.md §5)

    # Persistence
    model_path: Optional[str] = None   # reference main.py:35 --model (resume/eval)
    memory_path: Optional[str] = None  # reference main.py:57 --memory
    memory_save_interval: int = 0      # env-steps between replay-bearing
    # checkpoint saves when --memory is set. 0 = save at every evaluation
    # (reference parity, main.py:172-174); >0 decouples the (large) replay
    # write from the eval cadence.
    compress_memory: bool = True       # deflate the replay-bearing save —
    # the reference's bz2 pickling (main.py:85-100); opt out like its
    # --disable-bzip-memory.

    @property
    def conv_output_size(self) -> int:
        # The torso's output width, from its shapes (reference
        # model.py:58/63: 3136 canonical, 576 data-efficient; 15,488
        # impala-x4).
        from rainbow_tpu_torch.models.dqn import flat_size
        return flat_size(self.architecture, self.history_length,
                         self.frame_size)

    @property
    def capacity_per_env(self) -> int:
        # Total capacity is split evenly across the env ring buffers.
        return max(self.memory_capacity // max(self.num_envs, 1), 1)

    def replace(self, **kw) -> "RainbowConfig":
        return dataclasses.replace(self, **kw)


def canonical(**overrides) -> RainbowConfig:
    """Canonical Rainbow preset: the reference's argparse defaults."""
    return RainbowConfig(**overrides)


def data_efficient(**overrides) -> RainbowConfig:
    """Data-efficient Rainbow / Atari-100k preset (reference README.md:25-36)."""
    base = dict(
        target_update=2000,
        total_steps=100_000,
        learn_start=1600,
        memory_capacity=100_000,
        replay_frequency=1,
        multi_step=20,
        architecture="data-efficient",
        hidden_size=256,
        learning_rate=0.0001,
        evaluation_interval=10_000,
    )
    base.update(overrides)
    return RainbowConfig(**base)


def throughput(**overrides) -> RainbowConfig:
    """Opt-in large-batch throughput preset (no reference equivalent).

    The canonical learner is kernel-LATENCY-bound, not flops-bound: one
    batch-32 update is a ~50-kernel serial chain costing ~0.7 ms on a v5e
    regardless of how little each kernel computes (docs/results_r3 §2/§6).
    This preset keeps the canonical REPLAY RATIO in samples (8 sampled
    transitions per env-step: batch 256 @ one update per 32 env-steps ==
    batch 32 @ one per 4) but runs 8× fewer, 8× wider updates, amortising
    the fixed kernel chain across 8× the samples; lr scales by √8 (Adam
    sqrt-scaling) to keep the per-sample learning signal comparable.
    Quality-gated: results committed under docs/results_r4 compare its
    learning curves against the canonical preset at equal env-step budget.
    """
    base = dict(
        batch_size=256,
        replay_frequency=32,
    )
    base.update(overrides)
    if "learning_rate" not in base:
        # sqrt-scale from the canonical batch-32 lr for WHATEVER batch the
        # caller chose, so batch_size overrides stay correctly tuned.
        base["learning_rate"] = 6.25e-5 * (base["batch_size"] / 32) ** 0.5
    return RainbowConfig(**base)


PRESETS = {"canonical": canonical, "data-efficient": data_efficient,
           "throughput": throughput}
