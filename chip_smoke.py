#!/usr/bin/env python3
"""Drive the PyTorch port (rainbow_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

The checks of every kernel, and of every path that runs them, against
its plain version on the card live in one place,
tests/test_torch_port_cuda.py, with its cases from tests/card_cases.py:
the configurations this script's Trainers run and BENCHMARK.json's cells.
This script runs those tests, then the port's Trainers, its learning, its
data-parallel ranks and its kernels' timing rows. Phases, in order; any
failure ends the run with a traceback and a nonzero exit code:

1. build    nvcc builds the CUDA kernels (one process per source, started
            together) into rainbow_tpu_torch/_build/, while make builds the
            native Atari engine.
2. card     tests/test_torch_port_cuda.py in this process (pytest.main):
            each kernel and each path on the card against its plain version
            at the main path's shapes, among them one learner update and
            one act of each BENCHMARK.json cell with their launch counts;
            the counts of passed, failed and skipped tests on one line, the
            tests' output in card_tests.txt and their JUnit XML in
            card_tests.xml. A failed or skipped test fails the run.
3. replay   the replay's sampler, gather and write-back (K5-K7) timed on a
            random ring of the canonical width (7.05 GB) at the canonical
            round (K6 also at the throughput preset's) and on the
            data-efficient preset's whole 16 x 6,250 ring at its round,
            early in the run, where the profiler's split of K5's two
            launches agrees with the graphs; the last of six real 1024-env
            pong deltas kept for K10's row.
4. actor    the canonical preset on the native engine (pong, 1024 envs, the
            full 976-column replay ring on the device, per-env noise):
            actor_step_packed iterations, env-steps/s, launch counts.
5. evaluate build_validation_states + evaluate(): ε-greedy episodes and the
            validation-Q probe, launch counts.
6. train    the fused training iteration at the same width: a warm-up of
            actor iterations, then train_iter_packed with 256 updates per
            iteration (batch 32, the canonical replay ratio), one of them
            with the target sync: env-steps/s, updates/s, launch counts.
7. trainer  the main path: the Trainer through cli.main at the same width
            (31 warm-up iterations, 9 of 256 updates, an evaluation and a
            checkpoint, the best model, metrics and plots); a replay-bearing
            save on a 64-column ring restored exactly into a new Trainer;
            --evaluate of the best model. Launch counts, and beside them
            the torso forwards by the layout their input came in (the
            act's channels-last, the learner's NCHW; K5-K7 once per
            round), KA's launches by shape, env-steps/s, updates/s, eval,
            save and restore times, the peak of allocated device memory,
            KC's launches by N, K and mode, K5's by B.
            Then the side paths, each with its own launch counts: the
            sequential PER round (4 rounds of 256 updates, K5-K7 and K2
            once per update), and delta uploads (K10) with the pipelined
            actor (depth 2) and an asynchronous evaluation (9 rounds).
            Then the JAX package's other configurations through cli.main
            at their published widths (PRESET_RUNS, cuts in CUTS):
            [trainer data-efficient] (16 envs, the preset's 100,000-slot
            ring, 101 rounds of 16 updates, an evaluation and a checkpoint,
            the replay-bearing save restored bit for bit), [trainer
            throughput] (1024 envs, 9 rounds of 32 updates of batch 256)
            and [trainer bf16] (bfloat16 compute and Adam first moment, 4
            rounds, its checkpoint restored bit for bit), each with
            env-steps/s and updates/s over one span, evaluation seconds,
            peak allocated memory, every round's loss finite and every
            kernel's launches by shape and dtype; its ring freed before the
            next. [learning]: the JAX package's learning smoke
            (tests/test_train_smoke.py, fake env, seeds 7, 3, 42) through
            cli.main on the card, cuDNN deterministic, each seed's greedy
            score printed, failing the run unless one clears 1.5 x random;
            then the three seeds with cuDNN's default algorithms, printed.
8. distributed  the data-parallel learner (parallel/learner.py) at the
            canonical width, cuDNN held to its deterministic algorithms:
            (a) a world-size-1 NCCL group in this process, a batched round
            of 256 updates (batch 32, the full 1024-env ring) and a
            sequential round of 32, each bit for bit against
            train.learner_round on the same draws, with the same launches;
            (b) two ranks of this script (--rank) on the one card over gloo,
            512 envs and a full ring each: two batched rounds of 256
            updates with their own draws, the ranks' params bit-identical
            after each, then each rank's Trainer through cli.main
            (--process-count 2 --pipeline-actor: 2 rounds, the chief's
            evaluation, a
            replay-bearing save per rank restored exactly, one more round);
            this process then holds both shards on the card and runs the
            same two rounds, which must give the ranks' bits. The all-reduce
            of one update's gradients is timed over NCCL and gloo. Nothing
            wider is measured: NCCL puts no two ranks on one device.
9. kernels  each kernel's time against its plain version, a library call
            and its bound, at the main path's shapes (KA's forward at the
            learner's, the target's and the actor's batch and its backward
            at the learner's, cold and warm, the library call's device time
            beside the kernel's; KB at B = 32, 1024 and 8192 with the
            probabilities, the C51 target and loss at B = 32, and K2 at
            the round's draw beside torch.randn of the same count, cold
            and warm, from CUDA graphs, beside one launch's floor, KB at
            B = 1; KC at N = 1024 with the Trainer's last K, and at
            N = 10 without a replay, K5 and K7 at B = 8192 and 32, K6 at
            the round, K10 at the last real delta beside its sector floor,
            K9 beside clip_grad_norm_ + fused Adam with its two launches
            apart, the same way); one
            JSON line, with each kernel's launches in the main Trainer
            (``launches``) and in the distributed phase
            (``distributed_launches``) among others; then a row for every
            shape the other configurations' Trainers launch that those
            rows do not hold (``phase``: its ``launches`` are that
            Trainer's, ``launches_at_shape`` at the row's shape). KA's rows
            name the CUDA kernels a call launches (``kernels``).

--time-rows {ka,adam,gather} TREE LABEL times only one kernel's rows (KA's,
K9's at its three nets, K6's at its three rounds) with the package of
TREE, for an A/B of the kernel against another commit in one call; K9's
and K6's rows carry the SHA-256 of their outputs on inputs from a seed.

The last line is {"ok": true, "device": {...}}. Without CUDA, or without
the rest of the repository beside it, the script exits nonzero and prints
no result. Every log line is also kept in chiprun_out/chip_smoke/log.txt,
with the longer logs.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
# The configurations and their calls, shared with the card tests.
sys.path.append(os.path.join(ROOT, "tests"))
from card_cases import (ADAM_HYPER, ENVS, GAME, PONG_ACTIONS,  # noqa: E402
                        PRESET_RUNS, SEED, adam_digests, adam_inputs,
                        noise_shapes, param_shapes, preset_configs, sha256)
ACTOR_ITERS = 200
EVAL_FRAMES = 4000  # max_episode_length of the evaluation episodes
WARMUP_ITERS = 32   # train phase: actor iterations that fill the ring
TRAIN_ITERS = 4     # then fused iterations with a learner round each
SYNC_AT = 2         # the train iteration that syncs the target net
PROFILE_UPDATES = 64  # --profile: the traced training iteration's round


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def log(*a):
    """Print a line and keep it in OUT_DIR/log.txt, where the first lines
    of a long run survive when only the end of its output is kept."""
    print(*a, flush=True)
    with open(os.path.join(OUT_DIR, "log.txt"), "a") as f:
        print(*a, file=f)


# A row's flop_dtype (float32 unless the row says bf16) as
# port_bench/bounds/peaks.py names the type of the operands.
PEAK_DTYPES = {"fp32": "float32", "bf16": "bfloat16"}


def bound_ms(flops, nbytes, flop_dtype="fp32"):
    """The least time one H100 could take, in ms, by the published peaks in
    port_bench/bounds/peaks.py: the larger of ``nbytes`` over the HBM3
    bandwidth and ``flops`` over the peak of ``flop_dtype`` (float32 on the
    CUDA cores, bf16 on the tensor cores)."""
    from port_bench.bounds.peaks import bound_s

    return 1e3 * bound_s(flops, nbytes, PEAK_DTYPES[flop_dtype])


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also trace 20 actor iterations and a training "
                   "iteration of 64 updates with torch.profiler "
                   "into chiprun_out/chip_smoke/")
    # One rank of the [distributed] phase, which starts two of them.
    p.add_argument("--time-rows", nargs=3,
                   metavar=("{" + ",".join(TIME_ROWS) + "}", "TREE", "LABEL"),
                   help="only time one kernel's rows (ka: KA_ROWS in "
                   "float32 and bf16; adam: K9 at the canonical net with a "
                   "float32 and a bf16 mu, at the data-efficient net and at "
                   "the canonical net with its grads as views of one flat "
                   "buffer; "
                   "gather: K6 at windows of 7 (256 x 32 and 32 x 256) and "
                   "24 (16 x 32)) with the rainbow_tpu_torch of TREE (e.g. "
                   "an unpacked archive of another commit) into chiprun_out/"
                   "chip_smoke/KIND_times_LABEL.json, K9's and K6's with the "
                   "SHA-256 of their outputs; run for two trees in turns (A, "
                   "B, B, A) to compare them on one card")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--work", default=None, help=argparse.SUPPRESS)
    return p.parse_args()


# --------------------------------------------------------------- timing ----

def time_ms(torch, fn, reps=30, warmup=3, before=None):
    """Median over ``reps`` of one call's CUDA-event time, in ms; ``before``
    runs ahead of each call, outside the events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_us(torch, fn, reps, before=None):
    """{kernel name: device µs in all} over ``reps`` profiled calls of
    ``fn``, each after ``before``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    out = {}  # key_averages() may hold more than one row of a name
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total
    return out


def device_ms(torch, fn, reps=10, before=None, only=""):
    """Mean device time of the kernels one call of ``fn`` launches, in ms,
    from torch.profiler over ``reps`` calls; ``before`` runs ahead of each
    call and its own kernels (those that ``before`` alone launches) are not
    counted, nor are kernels whose name does not hold ``only``."""
    fn()
    skip = set(_kernel_us(torch, before, 1)) if before is not None else set()
    us = sum(t for k, t in _kernel_us(torch, fn, reps, before).items()
             if only in k and k not in skip)
    return us / 1e3 / reps


def graph_ms(torch, fn, before=None, n=20, reps=5):
    """Device time of one call of ``fn``, in ms, free of the host's launch
    cost and of the profiler: ``n`` calls (each after ``before``) captured
    in a CUDA graph and replayed ``reps`` times between CUDA events, less
    the same for ``before`` alone; the median replay over ``n``. Inside a
    graph launches follow each other about a microsecond apart."""
    def per_call(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up outside the capture
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                body()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n)
        del graph
        torch.cuda.empty_cache()
        return statistics.median(times)

    if before is None:
        return per_call(fn)
    return per_call(lambda: (before(), fn())) - per_call(before)


def l2_flush(torch):
    """A ``before`` for time_ms and device_ms that leaves nothing of the
    timed call's inputs in the 50 MB L2: it writes 128 MB, so the L2 is
    left full of dirty lines, which the timed call's misses write back."""
    spill = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    return spill.zero_


def l2_clean_flush(torch):
    """As l2_flush, but it reads 128 MB: the L2 is left full of clean lines,
    so the timed call's misses write nothing back, and the lines the call
    writes are written back by the next flush, which counts them to it."""
    spill = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")
    return lambda: spill.amax()


def _replay_on_card(torch, e, c, seed, history=4):
    """A random canonical-width ring made on the card: frames, actions,
    rewards, nonterminals, episode starts (timestep 0) about one step in six,
    gamma-like priorities with some zeros."""
    from rainbow_tpu_torch.replay.prioritized import init_replay

    g = torch.Generator(device="cuda").manual_seed(seed)
    rep = init_replay(e, c, 84, "cuda")
    rep.frames.random_(0, 256, generator=g)
    rep.actions.random_(0, 6, generator=g)
    rep.rewards.normal_(generator=g)
    rep.timesteps.random_(0, 6, generator=g)
    rep.nonterminal.copy_(torch.rand((e, c), generator=g, device="cuda") > 0.1)
    pr = -torch.log(torch.rand((e, c), generator=g, device="cuda")
                    * torch.rand((e, c), generator=g, device="cuda"))
    pr[torch.rand((e, c), generator=g, device="cuda") < 0.1] = 0.0
    rep.priorities.copy_(pr)
    rep.max_priority.fill_(float(pr.max()))
    return rep, g


def ring_rows(torch, cfg, tp_cfg):
    """K5-K7's rows on a random ring of the canonical width (1024 envs x 976
    columns, 7.05 GB of frames on the card) at the canonical round, and
    K6's at the throughput preset's (``tp_cfg``: 32 batches of 256), each
    timed twice by replay_times. The ring is freed before it returns."""
    rep, g = _replay_on_card(torch, ENVS, cfg.capacity_per_env, 20)
    rep.index.fill_(500)
    rep.full.fill_(True)
    timed = [replay_times(torch, cfg, rep, g) for _ in range(2)]
    log("[replay times] " + json.dumps(timed))
    rows = replay_kernel_rows(torch, rep, g, ENVS // cfg.replay_frequency,
                              cfg.batch_size, cfg.multi_step, timed)
    timed = [replay_times(torch, tp_cfg, rep, g, ("gather_window",))
             for _ in range(2)]
    log("[replay times throughput] " + json.dumps(timed))
    rows += [dict(r, phase="throughput") for r in replay_kernel_rows(
        torch, rep, g, ENVS // tp_cfg.replay_frequency, tp_cfg.batch_size,
        tp_cfg.multi_step, timed, ("gather_window",))]
    del rep
    torch.cuda.empty_cache()
    return rows


def preset_ring_rows(torch, cfg):
    """K5-K7's rows on the data-efficient preset's whole ring (``cfg``: 16
    envs x 6,250 columns, 706 MB of frames on the card) at its round (16
    batches of 32, n = 20: a window of 24 frames), timed twice by
    replay_times. The ring is freed before it returns."""
    e, c, n = cfg.num_envs, cfg.capacity_per_env, cfg.multi_step
    rep, g = _replay_on_card(torch, e, c, 24)
    rep.index.fill_(500)
    rep.full.fill_(True)
    timed = [replay_times(torch, cfg, rep, g, seq=False) for _ in range(2)]
    log("[replay times data-efficient] " + json.dumps(timed))
    rows = [dict(r, phase="data-efficient") for r in replay_kernel_rows(
        torch, rep, g, e // cfg.replay_frequency, cfg.batch_size, n, timed,
        seq=False)]
    del rep
    torch.cuda.empty_cache()
    return rows


def pong_delta(torch, np, cfg, steps=6):
    """The last of ``steps`` real 1024-env pong deltas for K10's row: the
    native engine's step_delta on random actions, with the card's frame
    stack advanced by K10 and KC as delta uploads advance it. Returns
    (stack, offsets, pos, val)."""
    from rainbow_tpu_torch.envs.engine import BatchedEnv
    from rainbow_tpu_torch.kernels.append_framestack import append_framestack
    from rainbow_tpu_torch.kernels.delta import apply_delta
    from rainbow_tpu_torch.ops.preprocess import init_framestack
    from rainbow_tpu_torch.train import delta_offsets, pack_resets

    env = BatchedEnv(GAME, ENVS, SEED + 5)
    stack = init_framestack(ENVS, cfg.history_length, env.reset_all(),
                            "cuda")
    rng = np.random.default_rng(6)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    last = None
    for _ in range(steps):
        counts, dpos, dval, resets, _, _, kinds = env.step_delta(
            rng.integers(0, env.action_space, ENVS))
        if counts is None:  # the engine's dense fallback
            obs = cuda(dpos)
        else:
            last = (stack.clone(), cuda(delta_offsets(counts)), cuda(dpos),
                    cuda(dval))
            obs = apply_delta(stack, *last[1:])
        packed, ridx = pack_resets(resets, kinds)
        append_framestack(stack, obs, cuda(packed), cuda(ridx), cuda(kinds))
    env.close()
    check(last is not None, "pong_delta: no step took the delta form")
    return last


REPLAY_KERNELS = ("stratified_sample", "gather_window", "write_priorities")


def replay_times(torch, cfg, rep, g, kernels=REPLAY_KERNELS, seq=True):
    """Times of K5 and K7 at the round's B (8192 in the canonical one) and,
    with ``seq``, the sequential update's batch, and of K6 at the round, on
    the ring ``rep`` with ``cfg``'s round (its envs' updates of its batch,
    its n), through the wrappers of the rainbow_tpu_torch that is imported,
    by graphed_times; of ``kernels`` alone. Returns {"<name> B=<b>":
    {...}}."""
    import dataclasses

    from rainbow_tpu_torch.kernels import replay as k_replay

    nb = rep.priorities.shape[0] // cfg.replay_frequency
    bs, n = cfg.batch_size, cfg.multi_step
    b = nb * bs
    u = torch.rand(b, generator=g, device="cuda")
    u_seq = torch.rand(bs, generator=g, device="cuda")
    idx, p, total = k_replay.stratified_sample(rep, u, 4, n)
    idxs = idx.view(bs, nb).T.contiguous()
    losses = torch.rand((nb, bs), generator=g, device="cuda") * 5
    idxs_seq = k_replay.stratified_sample(rep, u_seq, 4, n)[0].view(1, bs)
    losses_seq = torch.rand((1, bs), generator=g, device="cuda") * 5
    copy = dataclasses.replace(rep, priorities=rep.priorities.clone(),
                               max_priority=rep.max_priority.clone())
    flush = l2_flush(torch)
    calls = {
        f"stratified_sample B={b}":
        lambda: k_replay.stratified_sample(rep, u, 4, n),
        f"stratified_sample B={bs}":
        lambda: k_replay.stratified_sample(rep, u_seq, 4, n),
        f"gather_window B={b}": lambda: k_replay.gather_window(
            rep, idx, p, total, 0.6, nb, bs, 4, n, 0.99),
        f"write_priorities B={b}":
        lambda: k_replay.write_priorities(copy, idxs, losses, 0.5),
        f"write_priorities B={bs}":
        lambda: k_replay.write_priorities(copy, idxs_seq, losses_seq, 0.5)}
    out = {key: graphed_times(torch, fn, flush) for key, fn in calls.items()
           if key.split()[0] in kernels and (seq or key.endswith(f"={b}"))}
    del copy
    torch.cuda.empty_cache()
    return out


def replay_kernel_rows(torch, rep, g, nb, bs, n, timed,
                       kernels=REPLAY_KERNELS, seq=True):
    """Rows of K5 and K7 (at the round's B = nb·bs and, with ``seq``, the
    sequential update's B = bs) and K6 at a round's shapes (nb batches of
    bs, n-step n) on the ring ``rep``, of ``kernels`` alone, from ``timed``
    (two replay_times of this run: device times from CUDA graphs, cold and
    warm, and CUDA event times), with the plain version's time. K6's bound
    counts the frames this round's draws need: each distinct frame that is
    not blanked read once, every window frame written. No single PyTorch
    call computes any of the three, so library_ms is null."""
    import dataclasses

    from rainbow_tpu_torch.kernels import replay as k_replay
    from rainbow_tpu_torch.replay import prioritized as rp

    e, c = rep.priorities.shape
    leaves, b, w, fp = e * c, nb * bs, 4 + n, rep.frames.shape[2]
    tree_levels = (1 << (leaves - 1).bit_length()) - 1
    u = torch.rand(b, generator=g, device="cuda")
    idx, p, total = k_replay.stratified_sample(rep, u, 4, n)
    cols = (idx[:, None] % c + torch.arange(-3, n + 1, device="cuda")) % c
    rows_of = (idx // c)[:, None] * c
    blank = rp._blank_masks(rep.timesteps.view(-1)[rows_of + cols] == 0, 4,
                            n)
    frames_read = int(torch.unique((rows_of + cols)[~blank]).numel())
    idxs = idx.view(bs, nb).T.contiguous()
    losses = torch.rand((nb, bs), generator=g, device="cuda") * 5
    copy = dataclasses.replace(rep, priorities=rep.priorities.clone(),
                               max_priority=rep.max_priority.clone())
    source = "rainbow_tpu_torch/kernels/csrc/replay.cu"
    flush = l2_flush(torch)
    plan = k_replay.tree_plan(leaves)
    rows = []
    for draws, who in ((b, "round"), (bs, "sequential update"))[:1 + seq]:
        if "stratified_sample" not in kernels:
            break
        ud = u[:draws]
        key = f"stratified_sample B={draws}"
        # The profiler's device time of each of the call's launches (early
        # in the run, where it agrees with the graphs), per call.
        split = {}
        for name, us in _kernel_us(torch, lambda: k_replay.stratified_sample(
                rep, ud, 4, n), 20, flush).items():
            for kernel in ("tree_build_kernel", "descend_kernel"):
                if kernel in name:
                    split[kernel] = us / 20 / 1e3
        rows.append(dict(
            name="stratified_sample", route="cuda", source=source,
            replaces="rainbow_tpu/replay/prioritized.py:102",
            shape=f"{e}x{c} leaves, B={draws} ({who})", draws=draws,
            tally_key=f"stratified_sample B={draws} on {e}x{c}",
            plan=dataclasses.asdict(plan),
            **timed[0][key], again=timed[1][key],
            profiler_device_ms_by_launch=split,
            plain_ms=time_ms(torch, lambda: rp.stratified_sample_plain(
                rep, ud, 4, n), before=flush),
            library_ms=None,
            # Read the priorities, the head and u; write idx, p, total.
            # The tree's adds, and per draw a compare and a subtract per
            # level.
            flops=tree_levels + 2 * draws * (tree_levels.bit_length()),
            bytes=4 * leaves + 4 + 4 * draws + 12 * draws + 4))
    if "gather_window" in kernels:
        key = f"gather_window B={b}"
        rows.append(dict(
            name="gather_window", route="cuda", source=source, draws=b,
            replaces="rainbow_tpu/replay/prioritized.py:157",
            shape=f"nb={nb} bs={bs} window={w} x {fp} B",
            tally_key=f"gather_window {nb}x{bs} window={w} on {e}x{c}",
            **timed[0][key], again=timed[1][key],
            plain_ms=time_ms(torch, lambda: rp.gather_window_plain(
                rep, idx, p, total, 0.6, nb, bs, 4, n, 0.99), before=flush),
            library_ms=None,
            # Read each distinct unblanked frame once; per draw its window's
            # timesteps, its n rewards, a nonterminal, an action, idx and
            # p; write the window and five scalars; per batch one max.
            flops=b * (2 * n + 8), frames_read=frames_read,
            bytes=(frames_read * fp + b * w * fp
                   + b * (4 * w + 4 * n + 1 + 4 + 8 + 4)
                   + b * (8 + 4 + 4 + 4 + 4) + 4 * nb + 4 + 4 + 1)))
    idxs_seq = idx[:bs].view(1, bs)
    losses_seq = losses[:1].clone()
    for draws, who, ix, ls in ((b, "round", idxs, losses),
                               (bs, "sequential update", idxs_seq,
                                losses_seq))[:(1 + seq) * (
                                    "write_priorities" in kernels)]:
        key = f"write_priorities B={draws}"
        rows.append(dict(
            name="write_priorities", route="cuda", source=source,
            replaces="rainbow_tpu/replay/prioritized.py:285",
            shape=f"B={draws} into {e}x{c} ({who})", draws=draws,
            tally_key=f"write_priorities B={draws} into {e}x{c}",
            plan={"threads": k_replay.WRITE_THREADS,
                  "blocks": k_replay.write_blocks(draws)},
            **timed[0][key], again=timed[1][key],
            plain_ms=time_ms(torch, lambda: rp.update_priorities_plain(
                copy, ix, ls, 0.5), before=flush),
            library_ms=None,
            # Read idxs, losses and max_priority, write the priorities and
            # max_priority; a pow and a compare a draw.
            flops=2 * draws,
            bytes=12 * draws + 4 * draws + 8))
    return rows


# ---------------------------------------------------------- card tests -----

def run_card_tests(torch):
    """[card tests]: tests/test_torch_port_cuda.py in this process, which
    holds every kernel, and every path that runs them (among them one
    learner update and one act of each BENCHMARK.json cell, with their
    launch counts), to its plain version at the main path's shapes. Its
    output goes to OUT_DIR/card_tests.txt, its JUnit XML beside it. Fails
    the run unless every test passed: none failed, errored or skipped.
    Returns {"passed", "failed", "skipped", "seconds"}."""
    import contextlib
    import gc
    import xml.etree.ElementTree as ET

    import pytest

    xml = os.path.join(OUT_DIR, "card_tests.xml")
    tests = os.path.join(ROOT, "tests", "test_torch_port_cuda.py")
    t0 = time.perf_counter()
    with open(os.path.join(OUT_DIR, "card_tests.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        rc = pytest.main([tests, "--noconftest", "-q", "-p",
                          "no:cacheprovider", f"--junitxml={xml}"])
    seconds = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    suite = ET.parse(xml).getroot()
    suite = suite.find("testsuite") if suite.tag == "testsuites" else suite
    n = {k: int(suite.get(k, 0))
         for k in ("tests", "failures", "errors", "skipped")}
    failed = [f"{c.get('classname')}::{c.get('name')}"
              for c in suite.iter("testcase")
              if c.find("failure") is not None or c.find("error") is not None]
    stats = {"passed": n["tests"] - n["failures"] - n["errors"]
             - n["skipped"], "failed": n["failures"] + n["errors"],
             "skipped": n["skipped"], "seconds": seconds}
    log("[card tests] " + json.dumps(stats))
    check(rc == 0 and stats["failed"] == stats["skipped"] == 0,
          f"[card tests] pytest exit {int(rc)}, {stats}, failed "
          f"{failed[:20]}: see {OUT_DIR}/card_tests.txt")
    return stats


# --------------------------------------------------------------- actor -----

def run_actor(torch, cfg, params, A, noise):
    """The acting path on the native engine: returns its stats."""
    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch.kernels import launches, reset_launches
    from rainbow_tpu_torch.ops.preprocess import (init_framestack,
                                                  to_network_input)
    from rainbow_tpu_torch.replay import prioritized as rp
    from rainbow_tpu_torch.train import (actor_step_packed, make_env_factory,
                                         stage_step)

    env = make_env_factory(cfg)(num_envs=ENVS, training=True)
    check(env.action_space == A, "action space changed")
    stack = init_framestack(ENVS, cfg.history_length, env.reset_all(),
                            "cuda")
    rep = rp.init_replay(ENVS, cfg.capacity_per_env, cfg.frame_size,
                         "cuda")
    ring_gb = rep.frames.numel() / 1e9
    torch.cuda.synchronize()

    reset_launches()
    t0 = time.perf_counter()
    actions = ag.act(params, cfg, A, to_network_input(stack), noise)
    actions_np = actions.cpu().numpy()
    engine_s = stage_s = 0.0
    iter_s = []
    for _ in range(ACTOR_ITERS):
        ti = time.perf_counter()
        out = env.step(actions_np)
        tj = time.perf_counter()
        staged = stage_step(out, "cuda")
        stage_s += time.perf_counter() - tj
        engine_s += tj - ti
        actions = actor_step_packed(params, noise, cfg, A, stack, rep,
                                    actions, *staged)
        actions_np = actions.cpu().numpy()  # the one sync of the step
        iter_s.append(time.perf_counter() - ti)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()

    it = ACTOR_ITERS
    check(counts == dict(dict.fromkeys(counts, 0),
                         noisy_linear_fwd=4 * (it + 1), dueling_head=it + 1,
                         scaled_noise=it + 1, append_framestack=it),
          f"actor launch counts {counts}, expected 4/1/1/1 per iteration "
          "plus the first act")
    stored = int(rp.stored_count(rep))
    check(stored == it * ENVS, f"stored_count {stored} != {it}·{ENVS}")
    check(int(rep.index) == it % cfg.capacity_per_env, "replay index")
    check(((actions_np >= 0) & (actions_np < A)).all(), "actions out of range")
    rw = rep.rewards[:, :it]
    check(bool((rw.abs() <= cfg.reward_clip).all()), "rewards not clipped")
    # The stack's newest frame is the last observation or the reset frame.
    obs, packed, ridx, _, _, kinds = staged
    newest = stack[..., -1]
    k0 = kinds == 0
    check(torch.equal(newest[k0], obs[k0]), "stack newest != observation")
    steady = iter_s[len(iter_s) // 10:]
    stats = {"envs": ENVS, "iters": it, "ring_gb": ring_gb,
             "wall_s": wall, "env_steps_per_s": it * ENVS / wall,
             "steady_env_steps_per_s": len(steady) * ENVS / sum(steady),
             "engine_s": engine_s, "upload_s": stage_s,
             "act_and_fetch_s": sum(iter_s) - engine_s - stage_s,
             "median_iter_ms":
             1e3 * statistics.median(iter_s), "launches": counts}
    env.close()
    return stats


def profiled(torch, name, fn, units, unit):
    """Run ``fn`` under torch.profiler: device time by kernel into
    chiprun_out/chip_smoke/<name>_profile.txt (and a chrome trace), headed
    by a log line with the device's busy time per ``unit`` (``units`` of
    them in ``fn``), its share of the wall time, and KA's (the noisy-linear
    kernels') device time per unit and share of the busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cuda_time_total", row_limit=40)
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"{name}_trace.json"))
    kernels = [e for e in avg
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    ka_us = sum(e.self_device_time_total for e in kernels
                if "noisy_linear" in e.key)
    line = f"[profile {name}] " + json.dumps({
        unit + "s": units, f"wall_ms_per_{unit}": 1e3 * wall / units,
        f"device_busy_ms_per_{unit}": busy_us / 1e3 / units,
        "device_busy_share": busy_us / 1e6 / wall,
        f"ka_device_ms_per_{unit}": ka_us / 1e3 / units,
        "ka_share_of_device": ka_us / busy_us if busy_us else 0.0})
    with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
        f.write(line + "\n" + table)
    log(line)
    log(table)


def profile_actor(torch, cfg, params, A, noise, iters=20):
    """torch.profiler over ``iters`` actor iterations on a fresh engine and
    a small ring (see ``profiled``)."""
    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch.ops.preprocess import (init_framestack,
                                                  to_network_input)
    from rainbow_tpu_torch.replay import prioritized as rp
    from rainbow_tpu_torch.train import (actor_step_packed, make_env_factory,
                                         stage_step)

    env = make_env_factory(cfg)(num_envs=ENVS, training=True)
    stack = init_framestack(ENVS, 4, env.reset_all(), "cuda")
    rep = rp.init_replay(ENVS, 64, 84, "cuda")
    actions = ag.act(params, cfg, A, to_network_input(stack), noise)

    def step(actions):
        out = env.step(actions.cpu().numpy())
        return actor_step_packed(params, noise, cfg, A, stack, rep, actions,
                                 *stage_step(out, "cuda"))
    for _ in range(5):
        actions = step(actions)

    def run():
        a = actions
        for _ in range(iters):
            a = step(a)
    profiled(torch, "actor", run, iters, "iter")
    env.close()


# --------------------------------------------------------------- train -----

def run_train(torch, np, cfg, A, profile=False):
    """The fused training iteration on the native engine at full width:
    WARMUP_ITERS warm-up iterations (num_learns = 0) fill the ring, then
    TRAIN_ITERS iterations each run a learner round of ENVS / replay_frequency
    updates before the append and the act, one with the target sync. The
    launch counters are zeroed just before the learning iterations and read
    just after. With ``profile``, one more iteration with a round of
    PROFILE_UPDATES updates runs under torch.profiler. Returns (stats,
    launch counts)."""
    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch.kernels import launches, reset_launches
    from rainbow_tpu_torch.kernels.noisy_linear import bwd_plan
    from rainbow_tpu_torch.ops.preprocess import (init_framestack,
                                                  to_network_input)
    from rainbow_tpu_torch.replay import prioritized as rp
    from rainbow_tpu_torch.train import (make_env_factory, stage_step,
                                         train_iter_packed)

    num_learns = ENVS // cfg.replay_frequency
    env = make_env_factory(cfg)(num_envs=ENVS, training=True)
    agent = ag.init_agent(cfg, A, SEED + 3, "cuda")
    stack = init_framestack(ENVS, cfg.history_length, env.reset_all(),
                            "cuda")
    rep = rp.init_replay(ENVS, cfg.capacity_per_env, cfg.frame_size, "cuda")
    actions = ag.act(agent.params, cfg, A, to_network_input(stack),
                     agent.noise)
    actions_np = actions.cpu().numpy()

    def iteration(n, beta, sync):
        """One iteration; returns (engine, upload, call, fetch) seconds."""
        nonlocal actions, actions_np
        t0 = time.perf_counter()
        out = env.step(actions_np)
        t1 = time.perf_counter()
        staged = stage_step(out, "cuda")
        t2 = time.perf_counter()
        actions, loss = train_iter_packed(cfg, A, n, agent, stack, rep,
                                          actions, *staged, beta, sync)
        t3 = time.perf_counter()
        actions_np = actions.cpu().numpy()  # the one sync of the iteration
        return (t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3), loss

    warm = [iteration(0, 0.0, False)[0] for _ in range(WARMUP_ITERS)]
    torch.cuda.synchronize()
    prio0 = rep.priorities[:, :WARMUP_ITERS].clone()
    max_p0 = float(rep.max_priority)
    reset_launches()
    t_start = time.perf_counter()
    times, losses, synced = [], [], None
    for it in range(TRAIN_ITERS):
        t, loss = iteration(num_learns, cfg.priority_weight, it == SYNC_AT)
        times.append(t)
        losses.append(loss)
        if it == SYNC_AT:  # outside the timed iterations
            ts = time.perf_counter()
            synced = all(torch.equal(agent.target_params[k], v)
                         for k, v in agent.params.items())
            t_start += time.perf_counter() - ts
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = launches()
    adam_count = int(agent.opt_state.count)
    if profile:
        profiled(torch, "train", lambda: iteration(
            PROFILE_UPDATES, cfg.priority_weight, False), PROFILE_UPDATES,
            "update")
    env.close()

    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(synced, "train: target params differ from online right after sync")
    changed = int((rep.priorities[:, :WARMUP_ITERS] != prio0).sum())
    check(changed > 0, "train: the rounds wrote back no priority")
    max_p = float(rep.max_priority)
    check(max_p > max_p0, f"train: max_priority stayed at {max_p0}")
    check(adam_count == TRAIN_ITERS * num_learns, "train: Adam count")
    u, it = TRAIN_ITERS * num_learns, TRAIN_ITERS
    # K2: the round's target and online noise in one launch, the act's in
    # another.
    large = bwd_plan(cfg.batch_size, 3136, 512, 1).path == "large"
    want = {"noisy_linear_fwd": 8 * u + 8 * it, "noisy_linear_bwd": 4 * u,
            "noisy_linear_bwd_large": 4 * u if large else 0,
            "dueling_head": u + 2 * it, "c51_target": u, "head_loss": u,
            "append_framestack": it, "clip_adam": u, "stratified_sample": it,
            "gather_window": it, "write_priorities": it,
            "scaled_noise": 2 * it, "apply_delta": 0}
    check(counts == want, f"train launch counts {counts}, expected {want}")
    med = lambda rows, i: 1e3 * statistics.median(r[i] for r in rows)
    dev_ms = lambda rows: 1e3 * statistics.median(r[2] + r[3] for r in rows)
    stats = {
        "envs": ENVS, "warmup_iters": WARMUP_ITERS, "train_iters": it,
        "updates_per_iter": num_learns, "batch_size": cfg.batch_size,
        "ring_gb": rep.frames.numel() / 1e9, "wall_s": wall,
        "train_env_steps_per_s": it * ENVS / wall,
        "learner_updates_per_s": u / wall,
        "median_train_iter_ms": 1e3 * statistics.median(sum(r) for r in
                                                        times),
        "median_actor_iter_ms": 1e3 * statistics.median(sum(r) for r in
                                                        warm[4:]),
        # The learner round's share: the device part (the call and the
        # action fetch that waits for it) of a training iteration less that
        # of a warm-up iteration.
        "round_ms": dev_ms(times) - dev_ms(warm[4:]),
        "engine_ms": med(times, 0), "upload_ms": med(times, 1),
        "call_ms": med(times, 2), "fetch_ms": med(times, 3),
        "losses": losses, "priorities_rewritten": changed,
        "max_priority": [max_p0, max_p], "launches": counts}
    return stats, counts


# ------------------------------------------------------------- trainer -----

TRAINER_ARGS = ["--num-envs", "1024", "--learn-start", "32768", "--T-max",
                "40960", "--evaluation-interval", "36864",
                "--checkpoint-interval", "36864", "--max-episode-length",
                "4000", "--id", "chip_trainer", "--seed", "0"]
# The replay-bearing save and restore: a 64-column ring (462 MB of frames),
# 8 iterations, rounds from T = 4096, the evaluation and the save at the end.
MEMORY_ARGS = ["--num-envs", "1024", "--memory-capacity", "65536",
               "--memory", "memory", "--learn-start", "4096", "--T-max",
               "8192", "--evaluation-interval", "8192",
               "--max-episode-length", "4000", "--id", "chip_trainer_memory",
               "--seed", "1"]


class _Watch:
    """Wraps train.train_iter_sharded (the Trainer's iteration),
    Trainer.evaluate_now and Trainer.save_checkpoint to time them (each
    iteration synchronised with ``sync``, each learning iteration's loss
    kept in ``losses``), Trainer._eval_async_drain to mark the end of each
    run's
    training loop (``loop_ends``: its first call with ``wait``, after the
    main stream has finished), every kernel's wrapper but K10's to count
    its launches by shape in ``shapes`` (KA's by B, layer, noise mode and
    dtype, KB's and K4's by B and the streams' dtype, KC's by N, K and with
    or without a replay, with each N's last K with a replay in
    ``kc_last_k_by_n``, K5's and K7's by B and ring, K6's by batches x
    batch, window and ring, K9's by params and mu's dtype, K2's by floats a
    draw), and the replay's, the noise's and the delta's plain versions to
    fail if the card's path calls them."""

    def __init__(self, torch, sync=True):
        from rainbow_tpu_torch import agent as ag
        from rainbow_tpu_torch import train as tm
        from rainbow_tpu_torch.models import noisy
        from rainbow_tpu_torch.ops import c51 as oc51
        from rainbow_tpu_torch.ops import head
        from rainbow_tpu_torch.ops import preprocess as pp
        from rainbow_tpu_torch.replay import prioritized as rp

        self.iters, self.evals, self.saves, self.losses = [], [], [], []
        self.shapes, self.kc_last_k_by_n = {}, {}
        tally_lock = threading.Lock()  # an async evaluation appends too
        self.loop_ends = []
        self._undo = []

        def timed_iter(real):
            def wrapper(*args):
                t0 = time.perf_counter()
                out = real(*args)
                if sync:
                    torch.cuda.synchronize()
                self.iters.append((args[2], t0, time.perf_counter()))
                if args[2]:
                    self.losses.append(out[1])
                return out
            return wrapper

        def timed(real, into):
            def wrapper(*args, **kw):
                t0 = time.perf_counter()
                out = real(*args, **kw)
                into.append(time.perf_counter() - t0)
                return out
            return wrapper

        def refuse(name, real, on_card):
            def wrapper(*args, **kw):
                check(not on_card(*args, **kw),
                      f"{name} ran on the card's path")
                return real(*args, **kw)
            return wrapper

        def tally(real, key_of):
            def wrapper(*args, **kw):
                key = key_of(*args, **kw)
                with tally_lock:
                    self.shapes[key] = self.shapes.get(key, 0) + 1
                return real(*args, **kw)
            return wrapper

        def ka_key(name, x, eps, w_mu):
            mode = ("mu" if eps is None else
                    "row" if eps[0].dim() == 2 else "shared")
            return (f"noisy_linear_{name} B={x.shape[0]} {x.shape[1]}->"
                    f"{w_mu.shape[0]} {mode} {_dt(x)}")

        def kc_key(stack, obs, packed, ridx, kinds, rep=None, *a):
            if rep is not None:
                self.kc_last_k_by_n[stack.shape[0]] = packed.shape[0]
            return _kc_key(stack.shape[0], packed.shape[0], rep is not None)

        def drain(real):
            def wrapper(trainer, wait=False):
                if wait and len(self.loop_ends) < self._loops:
                    torch.cuda.current_stream().synchronize()
                    self.loop_ends.append(time.perf_counter())
                return real(trainer, wait)
            return wrapper

        self._loops = 0
        # Each wrapper through the module its callers read it from:
        # models/noisy.py (KA: ka.noisy_linear_fwd(params, x, eps, relu),
        # ka.noisy_linear_bwd(w_mu, w_sig, x, g, eps, y); K2), ops/head.py
        # (KB), ops/preprocess.py (KC), ops/c51.py (K4),
        # replay/prioritized.py (K5-K7), agent.py (K9).
        kernels = {
            (noisy.ka, "noisy_linear_fwd"):
            lambda prm, x, eps, *a: ka_key("fwd", x, eps, prm["weight_mu"]),
            (noisy.ka, "noisy_linear_bwd"):
            lambda w_mu, w_sig, x, g, eps, *a: ka_key("bwd", x, eps, w_mu),
            (head.kb, "dueling_head_fwd"):
            lambda v, a, support, n_act, dist=None:
            f"dueling_head B={v.shape[0]} {dist} {_dt(v)}",
            (pp.kc, "append_framestack"): kc_key,
            (rp.k_replay, "stratified_sample"): lambda state, u, *a:
            f"stratified_sample B={u.shape[0]} on {_ring(state)}",
            (rp.k_replay, "gather_window"):
            lambda state, idx, p, total, beta, nb, bs, history, n, *a:
            f"gather_window {nb}x{bs} window={history + n} on "
            f"{_ring(state)}",
            (rp.k_replay, "write_priorities"): lambda state, idxs, *a:
            f"write_priorities B={idxs.numel()} into {_ring(state)}",
            (oc51.k4, "c51_target"):
            lambda pns, *a: f"c51_target B={pns.shape[0]}",
            (oc51.k4, "head_loss"):
            lambda v, *a: f"head_loss B={v.shape[0]} {_dt(v)}",
            (ag.k9, "clip_adam"): lambda params, grads, mu, *a:
            f"clip_adam {sum(p.numel() for p in params)} params mu "
            f"{_dt(mu[0])}",
            (noisy.k2, "scaled_noise"): lambda seed, offset, shapes, *a:
            f"scaled_noise {sum(math.prod(x) for x in shapes)} floats"}
        for (owner, name), key_of in kernels.items():
            self._patch(owner, name, lambda r, key_of=key_of: tally(r,
                                                                    key_of))
        self._patch(tm, "train_iter_sharded", timed_iter)
        self._patch(tm.Trainer, "_eval_async_drain", drain)
        self._patch(tm.Trainer, "run", lambda r: self._counted(r))
        self._patch(tm.Trainer, "evaluate_now",
                    lambda r: timed(r, self.evals))
        self._patch(tm.Trainer, "save_checkpoint",
                    lambda r: timed(r, self.saves))
        for name in ("stratified_sample_plain", "gather_window_plain",
                     "update_priorities_plain"):
            self._patch(rp, name, lambda r, name=name: refuse(
                name, r, lambda state, *a, **k: state.priorities.is_cuda))
        self._patch(noisy, "philox_noise_plain", lambda r: refuse(
            "philox_noise_plain", r,
            lambda seed, offset, shapes, device="cpu":
            torch.device(device).type == "cuda"))
        self._patch(tm, "_apply_delta_plain", lambda r: refuse(
            "_apply_delta_plain", r, lambda stack, *a: stack.is_cuda))

    def _counted(self, real):
        def wrapper(trainer):
            self._loops += 1
            return real(trainer)
        return wrapper

    def train_span(self, iters):
        """The training span of a run whose iterations are ``iters``: from
        the start of its first learning iteration to the end of its loop."""
        first = next(i for i, (n, _, _) in enumerate(iters) if n)
        return self.loop_ends[-1] - iters[first][1]

    def _patch(self, owner, name, make):
        real = getattr(owner, name)
        self._undo.append((owner, name, real))
        setattr(owner, name, make(real))

    def close(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)


def check_shapes(tag, shapes, counts):
    """A run's launches by shape (_Watch.shapes) add up to its launch
    counts, kernel by kernel, and KA's large backward ran exactly at the
    backward's shapes whose bwd_plan takes that path."""
    import torch

    from rainbow_tpu_torch.kernels.noisy_linear import bwd_plan

    by_kernel, large = {}, 0
    for key, n in shapes.items():
        name = key.split()[0]
        by_kernel[name] = by_kernel.get(name, 0) + n
        if name == "noisy_linear_bwd":
            _, b, dims, mode, dt = key.split()
            n_in, n_out = map(int, dims.split("->"))
            plan = bwd_plan(int(b[2:]), n_in, n_out,
                            ("mu", "shared", "row").index(mode),
                            torch.bfloat16 if dt == "bf16" else torch.float32)
            large += n if plan.path == "large" else 0
    check(by_kernel == {k: v for k, v in counts.items()
                        if v and k != "noisy_linear_bwd_large"},
          f"{tag} launches by shape {by_kernel} do not add up to {counts}")
    check(counts.get("noisy_linear_bwd_large", 0) == large,
          f"{tag} {counts.get('noisy_linear_bwd_large', 0)} large KA "
          f"backward launches, where bwd_plan takes that path at {large}")


def _dt(t):
    """A tensor's dtype in a launch tally: fp32 or bf16."""
    return str(t.dtype).replace("torch.float32", "fp32").replace(
        "torch.bfloat16", "bf16")


def _ring(state):
    """A ring's shape in a launch tally: envs x columns."""
    e, c = state.priorities.shape
    return f"{e}x{c}"


def _same_state(torch, a, b, replay=True):
    """The Trainers' agents (Adam's first moment in its own dtype),
    generators, T, metrics and, with ``replay``, replays are equal."""
    import dataclasses
    pa, pb = a.agent, b.agent
    same = all(x[k].dtype == y[k].dtype and torch.equal(x[k], y[k])
               for x, y in ((pa.params, pb.params),
                            (pa.target_params, pb.target_params),
                            (pa.opt_state.mu, pb.opt_state.mu),
                            (pa.opt_state.nu, pb.opt_state.nu)) for k in x)
    same &= torch.equal(pa.opt_state.count, pb.opt_state.count)
    same &= pa.step == pb.step and a.T == b.T and a.metrics == b.metrics
    same &= not replay or all(torch.equal(getattr(a.rep, f.name),
                                          getattr(b.rep, f.name))
                              for f in dataclasses.fields(a.rep))
    same &= all(torch.equal(x.get_state(), y.get_state())
                for x, y in ((pa.generator, pb.generator),
                             (a.eval_generator, b.eval_generator)))
    same &= pa.noise == pb.noise
    return bool(same)


def torso_input_counts(torch, cfg, tag):
    """The torso forwards since the last reset_torso_inputs (models.dqn: by
    architecture and whether the input came channels-last), printed beside
    the launch counts; every one must be of ``cfg``'s torso."""
    from rainbow_tpu_torch.models import dqn

    counts = {k: v for k, v in dqn.torso_inputs().items() if v}
    check(counts and all(k.split(".")[0] == cfg.architecture
                         for k in counts),
          f"{tag}: torso forwards {counts}, not all of {cfg.architecture}")
    return counts


def run_trainer(torch, np):
    """The Trainer through the command line, at canonical width on the
    native engine: TRAINER_ARGS (31 warm-up iterations, then 9 of 256
    updates from T = 32768, the evaluation and a checkpoint at T = 36864),
    then MEMORY_ARGS (a replay-bearing save, restored into a new Trainer and
    held exactly against the state that was saved), then --evaluate of the
    best model. Launch counts are zeroed just before the first run and read
    just after it. Returns (stats, launch counts)."""
    import shutil

    from rainbow_tpu_torch import cli
    from rainbow_tpu_torch import checkpoint as ckpt
    from rainbow_tpu_torch.kernels import launches, reset_launches
    from rainbow_tpu_torch.models.dqn import reset_torso_inputs
    from rainbow_tpu_torch.train import Trainer

    for run in ("chip_trainer", "chip_trainer_memory", "chip_trainer_eval"):
        shutil.rmtree(os.path.join(ROOT, "results", run), ignore_errors=True)
    watch = _Watch(torch)
    try:
        reset_launches()
        reset_torso_inputs()
        before_mb = torch.cuda.memory_allocated() / 2 ** 20
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = cli.main(TRAINER_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        forwards = torso_input_counts(torch, tr.cfg, "trainer")
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        iters, evals, saves = (list(watch.iters), list(watch.evals),
                               list(watch.saves))
        shapes = dict(watch.shapes)
        kc_last_k = watch.kc_last_k_by_n.get(ENVS)
        gross = watch.train_span(iters)
        res = tr.results_dir
        rounds = sum(1 for n, _, _ in iters if n)
        c = tr.cfg
        check(tr.T == c.total_steps and len(iters) == c.total_steps
              // c.num_envs and rounds == (c.total_steps - c.learn_start)
              // c.num_envs + 1,
              f"trainer: T {tr.T}, {len(iters)} iterations, {rounds} rounds")
        check(tr.metrics["steps"] == [c.evaluation_interval]
              and len(evals) == 1
              and len(saves) == 1, f"trainer: evaluations "
              f"{tr.metrics['steps']}, saves {len(saves)}")
        for name in ("metrics.json", "model.npz", "checkpoint.npz",
                     "Reward.html", "Q.html"):
            check(os.path.exists(os.path.join(res, name)),
                  f"trainer: {name} not written")
        check(all(np.isfinite(tr.metrics["Qs"][0])), "trainer: non-finite Q")
        check(np.isfinite(float(tr._last_loss)), "trainer: non-finite loss")
        check(all(counts[k] == rounds for k in ("stratified_sample",
                                                "gather_window",
                                                "write_priorities")),
              f"trainer: K5-K7 not once per round: {counts}")
        check(all(v > 0 for k, v in counts.items() if k not in MAYBE_ZERO)
              and counts["apply_delta"] == 0,
              f"trainer: a kernel never launched, or K10 without delta "
              f"uploads {counts}")
        # Training span: from the start of the first learning iteration to
        # the end of the loop (as for the side paths), less the save in it
        # and, for train_span_s, less the evaluation too.
        first = next(i for i, (n, _, _) in enumerate(iters) if n)
        span_with_eval = gross - sum(saves)
        span = span_with_eval - sum(evals)
        timer = dict(tr.timer.totals)
        T, envs = tr.T, c.num_envs
        model = os.path.join(res, "model.npz")
        updates = rounds * tr.learns_per_iter
        del tr
        torch.cuda.empty_cache()

        # The replay-bearing save and an exact restore.
        watch.saves.clear()
        tm = cli.main(MEMORY_ARGS)
        mem_path = os.path.join(tm.results_dir, "memory_checkpoint.npz")
        check(len(watch.saves) == 1 and os.path.exists(mem_path),
              "trainer: the replay-bearing save did not happen once")
        check(int(tm.rep.index) == 8 and bool(tm.rep.priorities.any()),
              "trainer: the small ring was not filled")
        save_s = watch.saves[0]
        tb = Trainer(tm.cfg)
        t1 = time.perf_counter()
        tb.restore_checkpoint(mem_path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t1
        check(_same_state(torch, tm, tb),
              "trainer: the restored state differs from the saved one")
        mem_mb = os.path.getsize(mem_path) / 2 ** 20
        ring_mb = tm.rep.frames.numel() / 2 ** 20
        tb.env.close()
        del tm, tb
        torch.cuda.empty_cache()

        # --evaluate of the best model.
        te = cli.main(TRAINER_ARGS[:-4] + ["--id", "chip_trainer_eval",
                                           "--seed", "0", "--evaluate",
                                           "--model", model])
        saved = ckpt.load_params(model)
        check(all(torch.equal(te.agent.params[k], v)
                  for k, v in saved.items()),
              "trainer: --model did not load the best model")
        te.env.close()
        eval_only_s = watch.evals[-1]
        del te, saved
        torch.cuda.empty_cache()
    finally:
        watch.close()
    stats = {
        "envs": envs, "T": T, "iterations": len(iters), "rounds": rounds,
        "updates_per_round": updates // rounds, "run_wall_s": wall,
        "train_span_s": span,
        "train_env_steps_per_s": rounds * envs / span,
        "learner_updates_per_s": updates / span,
        "train_span_with_eval_s": span_with_eval,
        "train_with_eval_env_steps_per_s": rounds * envs / span_with_eval,
        "median_round_call_ms": 1e3 * statistics.median(
            b - a for n, a, b in iters if n),
        "median_warmup_call_ms": 1e3 * statistics.median(
            b - a for n, a, b in iters[4:first]),
        "timer_s": timer, "eval_s": evals[0], "checkpoint_save_s": saves[0],
        "replay_save_s": save_s, "replay_restore_s": restore_s,
        "replay_checkpoint_mb": mem_mb, "replay_frames_mb": ring_mb,
        "evaluate_only_s": eval_only_s, "max_memory_allocated_mb": peak_mb,
        "allocated_before_mb": before_mb,
        "launches": counts, "torso_inputs": forwards,
        "launches_by_shape": shapes, "kc_last_k": kc_last_k}
    check_shapes("trainer", shapes, counts)
    return stats, counts


# The side paths through the command line, at the same width: the
# sequential PER round (32 warm-up iterations, then 4 rounds of 256
# sequential updates, no evaluation); the pipelined actor (depth 2) alone
# and with delta uploads and an asynchronous evaluation at T = 36864 (each
# 31 warm-up iterations, then 9 rounds, as TRAINER_ARGS).
SEQUENTIAL_ARGS = ["--num-envs", "1024", "--sequential-per", "--learn-start",
                   "32768", "--T-max", "35840", "--evaluation-interval",
                   "1000000", "--max-episode-length", "4000", "--id",
                   "chip_trainer_sequential", "--seed", "2"]
PIPELINE_ARGS = ["--num-envs", "1024", "--pipeline-actor", "--pipeline-depth",
                 "2", "--learn-start", "32768", "--T-max", "40960",
                 "--evaluation-interval", "1000000", "--max-episode-length",
                 "4000", "--id", "chip_trainer_pipeline", "--seed", "4"]
SIDE_ARGS = ["--num-envs", "1024", "--delta-uploads", "--pipeline-actor",
             "--pipeline-depth", "2", "--async-eval", "--learn-start",
             "32768", "--T-max", "40960", "--evaluation-interval", "36864",
             "--max-episode-length", "4000", "--id", "chip_trainer_side",
             "--seed", "3"]


def run_side_trainer(torch, np, args, sync):
    """One side-path Trainer through cli.main: launch counts zeroed just
    before it and read just after; the training span from the start of the
    first learning iteration to the end of the loop (the main stream
    synchronised there, an asynchronous evaluation left running), as for
    the main Trainer. With ``sync`` every iteration is synchronised and
    timed (not for the pipelined actor, whose overlap that would undo).
    Returns (stats, launch counts)."""
    import shutil

    from rainbow_tpu_torch import cli
    from rainbow_tpu_torch.kernels import launches, reset_launches

    run_id = args[args.index("--id") + 1]
    shutil.rmtree(os.path.join(ROOT, "results", run_id), ignore_errors=True)
    reset_launches()
    watch = _Watch(torch, sync=sync)
    try:
        t0 = time.perf_counter()
        tr = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
    finally:
        watch.close()
    iters, c = watch.iters, tr.cfg
    rounds = sum(1 for n, _, _ in iters if n)
    check(tr.T == c.total_steps and len(iters) == c.total_steps // c.num_envs
          and rounds == (c.total_steps - c.learn_start) // c.num_envs + 1,
          f"{run_id}: T {tr.T}, {len(iters)} iterations, {rounds} rounds")
    check(np.isfinite(float(tr._last_loss)), f"{run_id}: non-finite loss")
    updates = rounds * tr.learns_per_iter
    span = watch.train_span(iters)
    stats = {"envs": c.num_envs, "T": tr.T, "iterations": len(iters),
             "rounds": rounds, "updates_per_round": tr.learns_per_iter,
             "run_wall_s": wall, "train_span_s": span,
             "train_env_steps_per_s": rounds * c.num_envs / span,
             "learner_updates_per_s": updates / span,
             "upload_forms": dict(tr.upload_forms),
             "eval_steps": list(tr.metrics["steps"]),
             "noise_offset": tr.agent.noise.offset,
             "timer_s": dict(tr.timer.totals), "launches": counts,
             "launches_by_shape": dict(watch.shapes)}
    if sync:
        stats["median_round_call_ms"] = 1e3 * statistics.median(
            b - a for n, a, b in iters if n)
    if c.async_eval:
        check(tr.metrics["steps"] == [c.evaluation_interval]
              and all(np.isfinite(tr.metrics["Qs"][0])),
              f"{run_id}: evaluations {tr.metrics['steps']}")
    if c.sequential_per:  # K5-K7 and a K2 draw once per update
        check(all(counts[k] == updates for k in (
            "stratified_sample", "gather_window", "write_priorities"))
              and counts["scaled_noise"] >= updates
              and counts["apply_delta"] == 0,
              f"{run_id}: launch counts {counts}")
    if c.delta_uploads:
        check(counts["apply_delta"] == tr.upload_forms["delta"] > 0
              and sum(tr.upload_forms.values()) == len(iters),
              f"{run_id}: K10 launches {counts['apply_delta']}, upload forms "
              f"{tr.upload_forms}")
    check(all(v > 0 for k, v in counts.items()
              if k != "noisy_linear_bwd_large"
              and (k != "apply_delta" or c.delta_uploads)),
          f"{run_id}: a kernel never launched {counts}")
    tr.env.close()
    del tr
    torch.cuda.empty_cache()
    return stats, counts


# ----------------------------------------------------- other presets -----


CUTS = {
    "data-efficient": "T-max 100,000 -> 3,200 (101 rounds); evaluation "
                      "interval 10,000 -> 3,200; max episode length "
                      "108,000 -> 4,000 frames",
    "throughput": "T-max 50M -> 40,960 (9 rounds); learn start 20,000 -> "
                  "32,768 (the ring 32 columns deep); evaluation interval "
                  "100,000 -> 40,960; max episode length 108,000 -> 4,000",
    "bf16": "T-max 50M -> 35,840 (4 rounds); learn start 20,000 -> 32,768; "
            "evaluation interval 100,000 -> 35,840; max episode length "
            "108,000 -> 4,000",
}


def run_preset_trainer(torch, np, label, args):
    """One configuration's Trainer through cli.main (PRESET_RUNS): launch
    counts zeroed just before it and read just after; every iteration
    synchronised and timed; the training span from the start of the first
    learning iteration to the end of the loop, less the evaluation and the
    saves in it. Checks: the schedule, every kernel but K10 launched, K5-K7
    once per round, every round's loss finite, one evaluation with finite
    Q, the files, the launches by shape adding up to the counts, in bf16
    every stream in bf16 and mu in bf16; then the checkpoint (the
    replay-bearing save where --memory is set) restored bit for bit into a
    new Trainer. The ring is freed before it returns. Returns (stats, launch
    counts, launches by shape)."""
    import shutil

    from rainbow_tpu_torch import cli
    from rainbow_tpu_torch.kernels import launches, reset_launches
    from rainbow_tpu_torch.models.dqn import reset_torso_inputs
    from rainbow_tpu_torch.train import Trainer

    run_id = args[args.index("--id") + 1]
    shutil.rmtree(os.path.join(ROOT, "results", run_id), ignore_errors=True)
    torch.cuda.empty_cache()
    before_mb = torch.cuda.memory_allocated() / 2 ** 20
    watch = _Watch(torch)
    try:
        reset_launches()
        reset_torso_inputs()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        forwards = torso_input_counts(torch, tr.cfg, f"[trainer {label}]")
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        watch.close()
    iters, c = watch.iters, tr.cfg
    rounds = sum(1 for n, _, _ in iters if n)
    tag = f"[trainer {label}]"
    check(tr.T == c.total_steps and len(iters) == c.total_steps // c.num_envs
          and rounds == (c.total_steps - c.learn_start) // c.num_envs + 1
          and tr.agent.step == rounds * tr.learns_per_iter,
          f"{tag} T {tr.T}, {len(iters)} iterations, {rounds} rounds, "
          f"{tr.agent.step} updates")
    losses = torch.stack(watch.losses).cpu()
    check(len(watch.losses) == rounds and bool(torch.isfinite(losses).all()),
          f"{tag} non-finite losses {losses.tolist()}")
    check(tr.metrics["steps"] == [c.evaluation_interval]
          and len(watch.evals) == 1
          and all(np.isfinite(tr.metrics["Qs"][0])),
          f"{tag} evaluations {tr.metrics['steps']}")
    res = tr.results_dir
    for name in ("metrics.json", "model.npz", "checkpoint.npz"):
        check(os.path.exists(os.path.join(res, name)),
              f"{tag} {name} not written")
    check(all(counts[k] == rounds for k in ("stratified_sample",
                                            "gather_window",
                                            "write_priorities")),
          f"{tag} K5-K7 not once per round: {counts}")
    check(all(v > 0 for k, v in counts.items() if k not in MAYBE_ZERO)
          and counts["apply_delta"] == 0,
          f"{tag} a kernel never launched, or K10 without delta uploads "
          f"{counts}")
    shapes = dict(watch.shapes)
    check_shapes(tag, shapes, counts)
    if c.compute_dtype == "bfloat16":
        streams = [k for k in shapes if k.split()[0] in (
            "noisy_linear_fwd", "noisy_linear_bwd", "dueling_head",
            "head_loss")]
        check(all(k.endswith("bf16") for k in streams)
              and all(k.endswith("bf16") for k in shapes
                      if k.startswith("clip_adam")),
              f"{tag} a stream or mu not in bfloat16: {shapes}")
    span_with_eval = watch.train_span(iters) - sum(watch.saves)
    span = span_with_eval - sum(watch.evals)
    updates = rounds * tr.learns_per_iter
    stats = {
        "cuts": CUTS[label], "preset": args[args.index("--preset") + 1]
        if "--preset" in args else "canonical",
        "envs": c.num_envs, "T": tr.T, "iterations": len(iters),
        "rounds": rounds, "updates_per_round": tr.learns_per_iter,
        "batch_size": c.batch_size, "learning_rate": c.learning_rate,
        "multi_step": c.multi_step, "hidden_size": c.hidden_size,
        "compute_dtype": c.compute_dtype, "adam_mu_dtype": c.adam_mu_dtype,
        "ring": f"{c.num_envs}x{c.capacity_per_env}",
        "ring_gb": tr.rep.frames.numel() / 1e9, "run_wall_s": wall,
        "train_span_s": span,
        "train_env_steps_per_s": rounds * c.num_envs / span,
        "learner_updates_per_s": updates / span,
        "train_with_eval_env_steps_per_s": rounds * c.num_envs
        / span_with_eval,
        "median_round_call_ms": 1e3 * statistics.median(
            b - a for n, a, b in iters if n),
        "eval_s": watch.evals[0], "save_s": list(watch.saves),
        "max_memory_allocated_mb": peak_mb,
        "allocated_before_mb": before_mb,
        "losses": {"n": len(watch.losses), "first": float(losses[0]),
                   "last": float(losses[-1]), "all_finite": True},
        "launches": counts, "torso_inputs": forwards,
        "launches_by_shape": shapes,
        "kc_last_k_by_n": dict(watch.kc_last_k_by_n)}
    del losses, watch.losses[:]
    # The checkpoint a new Trainer restores bit for bit: the replay-bearing
    # save where --memory is set (its ring too), else checkpoint.npz into a
    # Trainer of a 64-column ring (the agent alone).
    path = os.path.join(res, "memory_checkpoint.npz" if c.memory_path
                        else "checkpoint.npz")
    tb = Trainer(c if c.memory_path else c.replace(
        memory_capacity=64 * c.num_envs))
    t1 = time.perf_counter()
    tb.restore_checkpoint(path)
    torch.cuda.synchronize()
    stats["restore_s"] = time.perf_counter() - t1
    stats["restored_mb"] = os.path.getsize(path) / 2 ** 20
    check(_same_state(torch, tr, tb, replay=bool(c.memory_path)),
          f"{tag} the restored state differs from the saved one ({path})")
    stats["restored_bit_for_bit"] = os.path.basename(path)
    tb.env.close()
    del tr, tb
    torch.cuda.empty_cache()
    return stats, counts, shapes


# The JAX package's learning smoke (tests/test_train_smoke.py:200-224, with
# tiny_cfg of :16-26) through the port's Trainer on the card: the fake env
# (reward 1 when the action is t mod A, readable from the frame's stripe),
# the data-efficient net at hidden 32, 8 envs, 6,000 steps from learn start
# 200, lr 1e-3; seeds 7, 3 and 42 in turn until a greedy probe scores more
# than 1.5 x the random policy's 50 / 4 per episode. A seed starts the
# port's Trainer from the JAX package's initial params for it
# (models.dqn.init_dqn_params), so the same seed is the JAX test's
# experiment but for the later draws (noise and replay uniforms), which
# are the port's own.
LEARN_SEEDS = (7, 3, 42)
LEARN_BAR = 1.5 * 50 / 4


def learn_args(seed):
    return ["--preset", "data-efficient", "--env-backend", "fake",
            "--num-envs", "8", "--memory-capacity", "4096", "--batch-size",
            "32", "--T-max", "6000", "--learn-start", "200",
            "--replay-frequency", "4", "--target-update", "128",
            "--evaluation-interval", str(10 ** 9), "--evaluation-episodes",
            "3", "--evaluation-size", "20", "--hidden-size", "32",
            "--multi-step", "3", "--max-episode-length", "400",
            "--learning-rate", "1e-3", "--seed", str(seed), "--id",
            f"chip_learning_{seed}"]


def greedy_probe_score(torch, tr):
    """The JAX test's probe (_greedy_probe_score): the Trainer's params, μ
    only, greedy on 8 fresh evaluation envs of the fake env (seed 99,
    50-step episodes) for 50 steps; the reward per env."""
    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch.envs.fake import FakeAtariEnv
    from rainbow_tpu_torch.ops.preprocess import (append_framestack,
                                                  init_framestack,
                                                  to_network_input)
    from rainbow_tpu_torch.train import stage_step

    env = FakeAtariEnv(8, seed=99, episode_len=50, training=False)
    stack = init_framestack(8, tr.cfg.history_length, env.reset_all(),
                            "cuda")
    total = 0.0
    for _ in range(50):
        acts = ag.act(tr.agent.params, tr.cfg, env.action_space,
                      to_network_input(stack))
        out = env.step(acts.cpu().numpy())
        total += float(out[2].sum())
        obs, packed, ridx, _, _, kinds = stage_step(out, "cuda")
        append_framestack(stack, obs, packed, ridx, kinds)
    return total / 8


def learn_seed(torch, np, seed):
    """One learning smoke run of ``seed`` through cli.main (learn_args):
    every kernel but K10 launched, the last loss finite. Returns (its
    score and stats, its launch counts)."""
    import shutil

    from rainbow_tpu_torch import cli
    from rainbow_tpu_torch.kernels import launches, reset_launches

    shutil.rmtree(os.path.join(ROOT, "results", f"chip_learning_{seed}"),
                  ignore_errors=True)
    reset_launches()
    t0 = time.perf_counter()
    tr = cli.main(learn_args(seed))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = launches()
    check(all(v > 0 for k, v in counts.items() if k not in MAYBE_ZERO),
          f"[learning] seed {seed}: a kernel never launched {counts}")
    check(np.isfinite(float(tr._last_loss)),
          f"[learning] seed {seed}: loss {tr._last_loss}")
    score = greedy_probe_score(torch, tr)
    log(f"[learning] seed {seed}: greedy probe {score} per episode (bar > "
        f"{LEARN_BAR}), {tr.agent.step} updates in {run_s:.1f} s")
    return ({"seed": seed, "score": score, "run_s": run_s,
             "updates": tr.agent.step, "last_loss": float(tr._last_loss)},
            counts)


def run_learning(torch, np):
    """[learning]: the learning smoke through cli.main on the card, every
    seed of LEARN_SEEDS, each score printed; it passes on the first seed
    whose greedy probe scores more than LEARN_BAR and fails the run if none
    does. cuDNN runs its deterministic algorithms here, so a seed scores
    the same in every run on one card and software stack. Then the same
    seeds with cuDNN's default algorithms, which decide nothing: their
    scores show how far one seed's score moves without the net changing.
    Every kernel but K10 must launch in each run. Returns (stats, the
    launch counts of the deterministic runs summed)."""
    before = torch.backends.cudnn.deterministic
    scores, default, total = [], [], {}
    try:
        torch.backends.cudnn.deterministic = True
        for seed in LEARN_SEEDS:
            entry, counts = learn_seed(torch, np, seed)
            scores.append(entry)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        torch.backends.cudnn.deterministic = False
        default = [learn_seed(torch, np, seed)[0] for seed in LEARN_SEEDS]
    finally:
        torch.backends.cudnn.deterministic = before
    passed = [e["seed"] for e in scores if e["score"] > LEARN_BAR]
    check(bool(passed), f"[learning] no seed of {LEARN_SEEDS} cleared "
          f"{LEARN_BAR}: {scores}")
    return {"bar": LEARN_BAR, "scores": scores,
            "passed_on_seed": passed[0],
            "cudnn_default_scores": default}, total


# --------------------------------------------------------- distributed -----

DIST_UPDATES = 256      # updates in each batched distributed round
DIST_SEQ_UPDATES = 32   # updates in the one-rank sequential round
DIST_BETA = 0.4
RANK_TIMEOUT_S = 600
# Each rank's Trainer: 512 of 1024 envs with the pipelined actor, 2 rounds
# of 256 updates from T = 5120, the chief's evaluation at T = 6144 with a
# replay-bearing save per rank (64 columns an env), which a new Trainer
# restores exactly and trains on for one more round.
RANK_TRAINER_ARGS = ["--num-envs", "1024", "--learn-start", "5120",
                     "--T-max", "6144", "--evaluation-interval", "6144",
                     "--memory-capacity", "65536", "--memory", "memory",
                     "--max-episode-length", "4000", "--pipeline-actor",
                     "--pipeline-depth", "2", "--id", "chip_distributed",
                     "--seed", "0", "--process-count", "2"]
# Launch counts that may read 0 in a Trainer run: K10's without delta
# uploads, and KA's large backward (a share of noisy_linear_bwd's) below
# BWD_LARGE_ROWS rows or in bf16.
MAYBE_ZERO = ("apply_delta", "noisy_linear_bwd_large")
ROUND_KERNELS = ("noisy_linear_fwd", "noisy_linear_bwd", "dueling_head",
                 "c51_target", "head_loss", "clip_adam", "stratified_sample",
                 "gather_window", "write_priorities", "scaled_noise")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_ring(torch, e, c, seed):
    """A random ring of e envs at full width (_replay_on_card), written to
    column 500 of a wrapped ring."""
    rep, _ = _replay_on_card(torch, e, c, seed)
    rep.index.fill_(500)
    rep.full.fill_(True)
    return rep


def _digest(torch, t):
    """A digest of a tensor's bits."""
    import hashlib
    return hashlib.sha256(t.detach().contiguous().reshape(-1).cpu()
                          .view(torch.uint8).numpy().tobytes()
                          ).hexdigest()[:24]


def _round_digests(torch, agents, reps, shards, loss):
    """Digests of the bits a round leaves: the loss, the first replica's
    params, target, Adam moments and count, and each local shard's
    priorities and max_priority under its global index."""
    a = agents[0]
    out = {"loss": _digest(torch, loss),
           "count": _digest(torch, a.opt_state.count)}
    for name, tree in (("params", a.params), ("target", a.target_params),
                       ("mu", a.opt_state.mu), ("nu", a.opt_state.nu)):
        out[name] = _digest(torch, torch.cat([v.reshape(-1).float()
                                              for v in tree.values()]))
    for s, rep in enumerate(reps):
        out[f"priorities{shards.index(s)}"] = _digest(torch, rep.priorities)
        out[f"max_priority{shards.index(s)}"] = _digest(torch,
                                                        rep.max_priority)
    return out


def allreduce_ms(torch, dist, numel, reps=10):
    """Median host time of one all_reduce of ``numel`` float32 on the card
    (the gradients' flat buffer of one update), synchronised each side."""
    buf = torch.ones(numel, dtype=torch.float32, device="cuda")
    times = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf)
        torch.cuda.synchronize()
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _round_draws(torch, cfg, A, nl, seq):
    """Draws of a round in train.learner_round's form, made on the card."""
    from rainbow_tpu_torch.models.dqn import draw_noise
    from rainbow_tpu_torch.models.noisy import NoiseStream

    bs = cfg.batch_size
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    ns = NoiseStream(SEED + 9)
    lead = (nl,) if seq else (nl * bs,)
    return {"u": torch.rand((nl, bs) if seq else (nl * bs,), generator=g,
                            device="cuda"),
            "target": draw_noise(cfg, A, ns, lead, "cuda"),
            "online": draw_noise(cfg, A, ns, (nl,), "cuda")}


def one_rank_rounds(torch, np, cfg, A):
    """(a) A world-size-1 NCCL group in this process: a batched round of
    DIST_UPDATES and a sequential round of DIST_SEQ_UPDATES updates through
    parallel.learner.distributed_round (its all-reduces run over NCCL), each
    against train.learner_round from the same agent, ring and draws, bit for
    bit (loss, params, target, Adam state, priorities, max_priority) and
    with the same launches. The all-reduce is timed first, which also sets
    NCCL up; the rounds run in turns, learner_round, distributed,
    distributed, learner_round, each from the same state. Returns (stats,
    the first distributed round's launch counts of each kind)."""
    import torch.distributed as dist

    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch import train as tt
    from rainbow_tpu_torch.kernels import launches, reset_launches
    from rainbow_tpu_torch.parallel import learner as pl

    stats, total = {}, {}
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        numel = sum(v.numel() for v in ag.init_agent(
            cfg, A, SEED, "cuda").params.values())
        stats["nccl_allreduce_ms_per_update"] = allreduce_ms(torch, dist,
                                                             numel)
        stats["grad_floats"] = numel
        rep = _dist_ring(torch, ENVS, cfg.capacity_per_env, 31)
        prio0, maxp0 = rep.priorities.clone(), rep.max_priority.clone()
        for seq, nl in ((False, DIST_UPDATES), (True, DIST_SEQ_UPDATES)):
            c = cfg.replace(sequential_per=seq)
            draws = _round_draws(torch, c, A, nl, seq)
            runs = []  # in turns: plain, distributed, distributed, plain
            for how in ("learner_round", "distributed", "distributed",
                        "learner_round"):
                agent = ag.init_agent(c, A, SEED + 5, "cuda")
                rep.priorities.copy_(prio0)
                rep.max_priority.copy_(maxp0)
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                if how == "distributed":
                    loss = pl.distributed_round(
                        [agent], [rep], c, A, nl, DIST_BETA,
                        pl.Shards(["cuda:0"], c), [draws])
                else:
                    loss = tt.learner_round(agent, rep, c, A, nl, DIST_BETA,
                                            draws)
                torch.cuda.synchronize()
                runs.append((how, time.perf_counter() - t0, launches(),
                             _round_digests(torch, [agent], [rep],
                                            pl.Shards(["cuda:0"], c), loss),
                             float(loss)))
            name = "sequential" if seq else "batched"
            for how, _, counts, digests, loss in runs[1:]:
                check(digests == runs[0][3], f"[distributed] one-rank NCCL "
                      f"{name}: {how} gives {digests}, learner_round "
                      f"{runs[0][3]}")
                check(counts == runs[0][2], f"[distributed] one-rank "
                      f"{name}: {how} launches {counts}, learner_round's "
                      f"{runs[0][2]}")
            cd = runs[1][2]
            check(all(cd[k] > 0 for k in ROUND_KERNELS if k !=
                      "scaled_noise"), f"[distributed] {name}: a kernel "
                  f"never launched {cd}")
            check(np.isfinite(runs[0][4]), f"[distributed] {name}: loss "
                  f"{runs[0][4]}")
            for k, v in cd.items():  # the first distributed round's
                total[k] = total.get(k, 0) + v
            stats[name] = {
                "updates": nl, "loss": runs[0][4], "bit_equal": True,
                "distributed_s": [r[1] for r in runs if r[0] ==
                                  "distributed"],
                "learner_round_s": [r[1] for r in runs if r[0] ==
                                    "learner_round"]}
        del rep, prio0
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return stats, total


def two_rank_rounds(torch, cfg, A):
    """(b) Two ranks of this script (``--rank``) on the one card over gloo,
    512 envs each with a full ring: two batched rounds of DIST_UPDATES
    updates each (their own draws), the ranks' params held bit-identical
    after each round (multihost.tensors_agree), then each rank's Trainer
    through cli.main with a replay-bearing save restored exactly. This
    process then holds both shards on the card (data parallel, devices
    cuda:0 twice) and runs the same two rounds: every digest must equal the
    ranks'. Any failure of a rank fails the run. Returns (stats, the ranks'
    launch counts summed)."""
    import shutil

    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch.parallel import learner as pl

    work = os.path.join(ROOT, "results", "chip_distributed_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--work", work], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    outs, deadline = [], time.monotonic() + RANK_TIMEOUT_S
    try:  # one deadline for the pair: a rank's wait takes what is left
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    ranks_s = time.perf_counter() - t0
    for r, out in enumerate(outs):
        with open(os.path.join(OUT_DIR, f"distributed_rank{r}.txt"),
                  "w") as f:
            f.write(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"[distributed] rank {r} exited with "
              f"{p.returncode}:\n{out[-3000:]}")
    res = []
    for r in (0, 1):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            res.append(json.load(f))
    t1 = time.perf_counter()
    n = ENVS // 2
    reps = [_dist_ring(torch, n, cfg.capacity_per_env, 40 + s)
            for s in (0, 1)]
    agents = pl.replicate(ag.init_agent(cfg, A, SEED + 7, "cuda:0"),
                          ["cuda:0", "cuda:0"])
    shards = pl.Shards(["cuda:0", "cuda:0"], cfg)
    for i in range(2):
        loss = pl.distributed_round(agents, reps, cfg, A, DIST_UPDATES,
                                    DIST_BETA, shards)
        want = _round_digests(torch, agents, reps, shards, loss)
        for r in (0, 1):
            got = res[r]["rounds"][i]
            check(all(got[k] == want[k] for k in got),
                  f"[distributed] round {i}: rank {r} {got} differs from "
                  f"one process with two shards {want}")
    one_process_s = time.perf_counter() - t1
    del reps, agents
    torch.cuda.empty_cache()
    counts = {}
    for r in res:
        for k, v in list(r["round_launches"].items()) + list(
                r["trainer_launches"].items()):
            counts[k] = counts.get(k, 0) + v
    stats = {"ranks_wall_s": ranks_s, "one_process_two_shards_s":
             one_process_s, "bit_equal_to_one_process": True,
             **{f"rank{i}": {k: v for k, v in r.items() if k != "rounds"}
                for i, r in enumerate(res)}}
    return stats, counts


def distributed_rank(args) -> int:
    """One rank of two_rank_rounds, in a process of its own on the card's
    cuda:0, in a gloo group with the other (the kernels are already
    built), working in ``args.work``/rank{R}/. Writes its results to
    ``args.work``/rank{R}.json."""
    import torch
    if not torch.cuda.is_available():
        return 1
    sys.path.insert(0, ROOT)
    # A directory of its own, so that what each rank writes is told apart.
    os.makedirs(os.path.join(args.work, f"rank{args.rank}"))
    os.chdir(os.path.join(args.work, f"rank{args.rank}"))
    import numpy as np
    import torch.distributed as dist

    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch import canonical, cli
    from rainbow_tpu_torch.envs import engine
    from rainbow_tpu_torch.kernels import launches, reset_launches
    from rainbow_tpu_torch.parallel import learner as pl
    from rainbow_tpu_torch.parallel.mesh import init_distributed
    from rainbow_tpu_torch.parallel.multihost import (agent_tensors,
                                                      tensors_agree)
    from rainbow_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    rank = args.rank
    # gloo: NCCL will not put two ranks on one card.
    init_distributed(f"127.0.0.1:{args.port}", 2, rank, "cuda:0",
                     backend="gloo")
    try:
        cfg = canonical(game=GAME, num_envs=ENVS, seed=SEED)
        probe = engine.BatchedEnv(GAME, 1, 0)
        A = probe.action_space
        probe.close()
        rep = _dist_ring(torch, ENVS // 2, cfg.capacity_per_env, 40 + rank)
        agent = ag.init_agent(cfg, A, SEED + 7, "cuda:0")
        shards = pl.Shards(["cuda:0"], cfg)
        out = {"rounds": [], "round_s": [], "agree": []}
        reset_launches()
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = pl.distributed_round([agent], [rep], cfg, A, DIST_UPDATES,
                                        DIST_BETA, shards)
            torch.cuda.synchronize()
            out["round_s"].append(time.perf_counter() - t0)
            out["agree"].append(tensors_agree(agent_tensors(agent)))
            check(out["agree"][-1], f"rank {rank}: replicas differ")
            check(np.isfinite(float(loss)), f"rank {rank}: loss {loss}")
            out["rounds"].append(_round_digests(torch, [agent], [rep],
                                                shards, loss))
        out["round_launches"] = launches()
        check(all(out["round_launches"][k] > 0 for k in ROUND_KERNELS),
              f"rank {rank}: a kernel never launched "
              f"{out['round_launches']}")
        numel = sum(v.numel() for v in agent.params.values())
        out["gloo_allreduce_ms_per_update"] = allreduce_ms(torch, dist,
                                                           numel)
        del rep, agent
        torch.cuda.empty_cache()

        reset_launches()
        t0 = time.perf_counter()
        tr = cli.main(RANK_TRAINER_ARGS + [
            "--process-id", str(rank), "--coordinator",
            f"127.0.0.1:{args.port}"], device="cuda:0")
        torch.cuda.synchronize()
        out["trainer_s"] = time.perf_counter() - t0
        out["trainer_launches"] = launches()
        c = tr.cfg
        rounds = (c.total_steps - c.learn_start) // c.num_envs + 1
        check(tr.T == c.total_steps and tr.envs_local == ENVS // 2
              and tr.agent.step == rounds * tr.learns_per_iter
              and tr.metrics["steps"] == [c.total_steps],
              f"rank {rank}: T {tr.T}, step {tr.agent.step}, evaluations "
              f"{tr.metrics['steps']}")
        check(all(v > 0 for k, v in out["trainer_launches"].items()
                  if k not in MAYBE_ZERO), f"rank {rank}: a kernel never "
              f"launched {out['trainer_launches']}")
        check(tensors_agree(agent_tensors(tr.agent)),
              f"rank {rank}: the Trainers' replicas differ")
        mine = sorted(os.listdir(tr.results_dir))
        chief = ["Q.html", "Reward.html", "metrics.json", "model.npz"]
        check(mine == sorted([f"memory_checkpoint.npz.proc{rank}-of-2"]
                             + chief * (rank == 0)),
              f"rank {rank}: files {mine}")
        tr2 = Trainer(c.replace(run_id="chip_distributed_restore",
                                total_steps=c.total_steps + c.num_envs),
                      device="cuda:0")
        t0 = time.perf_counter()
        tr2.restore_checkpoint(os.path.join(tr.results_dir,
                                            "memory_checkpoint.npz"))
        out["restore_s"] = time.perf_counter() - t0
        want, got = agent_tensors(tr.agent), agent_tensors(tr2.agent)
        check(tr2.T == tr.T and tr2.agent.noise == tr.agent.noise
              and all(torch.equal(got[k], v) for k, v in want.items())
              and all(torch.equal(getattr(tr2.rep, f), getattr(tr.rep, f))
                      for f in ("frames", "priorities", "index", "full",
                                "t", "max_priority")),
              f"rank {rank}: the restore is not exact")
        tr.env.close()
        del tr
        tr2.run()
        check(tr2.T == c.total_steps + c.num_envs
              and tensors_agree(agent_tensors(tr2.agent)),
              f"rank {rank}: after the restore, T {tr2.T} or replicas "
              "differ")
        out["restored_step"] = tr2.agent.step
        with open(os.path.join(args.work, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        print(f"rank {rank}: " + json.dumps(
            {k: v for k, v in out.items() if k != "rounds"}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def run_distributed(torch, np, cfg, A):
    """[distributed]: one_rank_rounds (NCCL, world size 1) and
    two_rank_rounds (two gloo ranks on the card), with cuDNN held to its
    deterministic algorithms so that equal inputs give equal bits. Nothing
    wider was measured: NCCL puts no two ranks on one device. Returns
    (stats, the distributed launch counts of both)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        one, one_counts = one_rank_rounds(torch, np, cfg, A)
        t1 = time.perf_counter()
        two, two_counts = two_rank_rounds(torch, cfg, A)
        t2 = time.perf_counter()
    finally:
        torch.backends.cudnn.deterministic = before
    counts = {k: one_counts.get(k, 0) + two_counts.get(k, 0)
              for k in set(one_counts) | set(two_counts)}
    return {"one_rank_nccl": one, "two_gloo_ranks": two,
            "one_rank_wall_s": t1 - t0, "two_rank_wall_s": t2 - t1,
            "launches": counts}, counts


# ------------------------------------------------------------- kernels -----

def kc_cases(k_last):
    """KC's timed shapes, as (N, K, with a replay, caller): the Trainer's
    1024-env append at its last K, and the evaluation's 10-env frame-stack
    step without resets."""
    return ((ENVS, k_last, True, "Trainer append, its last K"),
            (10, 0, False, "evaluation, frame stack only"))


def _kc_key(n, k, with_rep):
    return f"append_framestack N={n} K={k} {'replay' if with_rep else 'stack'}"


def _kc_args(torch, np, n, k, with_rep, seed=23):
    """One append's arguments on the card, from a seed: n envs with H = 4,
    k reset rows (k envs reset, packed by pack_resets into a bucket of k),
    and with a replay a two-column ring."""
    from rainbow_tpu_torch.replay.prioritized import init_replay
    from rainbow_tpu_torch.train import pack_resets

    rng = np.random.default_rng(seed)
    kinds = np.zeros(n, np.uint8)
    kinds[rng.choice(n, size=k, replace=False)] = rng.integers(1, 3, k)
    packed, ridx = pack_resets(rng.integers(0, 256, (n, 84, 84), np.uint8),
                               kinds)
    check(packed.shape[0] == k, f"KC inputs: {packed.shape[0]} rows, not {k}")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    args = (up(rng.integers(0, 256, (n, 84, 84, 4), np.uint8)),
            up(rng.integers(0, 256, (n, 84, 84), np.uint8)), up(packed),
            up(ridx), up(kinds))
    if not with_rep:
        return args
    return args + (init_replay(n, 2, 84, "cuda"), up(rng.integers(0, 6, n)),
                   up(rng.normal(size=n).astype(np.float32)), up(kinds > 0),
                   1.0)


def kc_times(torch, np, k_last, cases=None):
    """KC's times at kc_cases(k_last), or at ``cases`` (as kc_cases'),
    through the wrapper of the rainbow_tpu_torch that is imported, by
    graphed_times. Returns {_kc_key(...): {...}}."""
    from rainbow_tpu_torch.kernels.append_framestack import append_framestack

    flush = l2_flush(torch)
    out = {}
    for n, k, with_rep, _ in cases or kc_cases(k_last):
        args = _kc_args(torch, np, n, k, with_rep)
        out[_kc_key(n, k, with_rep)] = graphed_times(
            torch, lambda: append_framestack(*args), flush)
        del args
    return out


def kc_row(torch, np, n, k, with_rep, who, kc_timed):
    """KC's row at N = n with k reset rows, with or without a replay, from
    ``kc_timed`` (two kc_times of this run holding its key), with the plain
    version's time."""
    import dataclasses

    from rainbow_tpu_torch.kernels.append_framestack import launch_plan
    from rainbow_tpu_torch.ops import preprocess as pp

    p = 84 * 84
    key = _kc_key(n, k, with_rep)
    args = _kc_args(torch, np, n, k, with_rep)
    # The stack in and out, obs, the reset rows and their indices, the
    # kinds; with a replay the frames column, the transition in, the ring's
    # scalars out and t in and out.
    nbytes = 2 * n * p * 4 + n * p + k * p + 4 * k + n
    if with_rep:
        nbytes += n * p + n * (8 + 4 + 1) + n * (4 + 4 + 4 + 1 + 4) + 8 * n
    return dict(
        name="append_framestack", route="cuda",
        source="rainbow_tpu_torch/kernels/csrc/append_framestack.cu",
        replaces="rainbow_tpu/replay/prioritized.py:73",
        shape=f"N={n} H=4 K={k} {'with' if with_rep else 'without'} a "
              f"replay ({who})",
        plan=dataclasses.asdict(launch_plan(n, p, 4)),
        tally_key=key,
        **kc_timed[0][key], again=kc_timed[1][key],
        plain_ms=time_ms(torch, lambda: pp.append_framestack_plain(*args),
                         before=l2_flush(torch)),
        library_ms=None, flops=0, bytes=nbytes)


def preset_rows(torch, np, A, presets, de_k_last):
    """Rows of the shapes that the preset Trainers (PRESET_RUNS) launch and
    the main path's rows do not hold, each tagged with its ``phase``:
    data-efficient: KA's fc_h (576 -> 256) forward at the learner's batch
    (shared noise), the round's target rows and the act's envs (per-row
    noise) and its backward, KB at the act and the round's target, K9 over
    its params, K2 at its round's draw, KC at its envs with the Trainer's
    last K; throughput: KA's fc_h forward and backward at batch 256, KB at
    the learner's a*, the C51 target and loss at 256, K2 at its round's
    draw; bf16: KA's KA_ROWS in bf16, KB at its three shapes and the loss
    in bf16, K9 with a bf16 mu. K5-K7 of the data-efficient ring and K6 of
    the throughput round come from the replay phase. Timed as the main
    path's rows."""
    de, tp, bf = (presets[k] for k in ("data-efficient", "throughput",
                                        "bf16"))
    target = lambda c: c.num_envs // c.replay_frequency * c.batch_size
    fc_h = lambda c: (c.conv_output_size, c.hidden_size)
    rows = []
    ka = {"data-efficient": (
              ("fwd", de.batch_size, *fc_h(de), "shared", "fp32", "learner"),
              ("fwd", target(de), *fc_h(de), "row", "fp32", "target"),
              ("fwd", de.num_envs, *fc_h(de), "row", "fp32", "actor"),
              ("bwd", de.batch_size, *fc_h(de), "shared", "fp32",
               "learner")),
          "throughput": (
              ("fwd", tp.batch_size, *fc_h(tp), "shared", "fp32", "learner"),
              ("bwd", tp.batch_size, *fc_h(tp), "shared", "fp32",
               "learner")),
          "bf16": tuple(c[:5] + ("bf16",) + c[6:] for c in KA_ROWS)}
    for phase, cases in ka.items():
        rows += [dict(r, phase=phase) for r in ka_rows(torch, cases)]
    heads = {"data-efficient": (de, (
                 ("dueling_head", de.num_envs, None, "act", "fp32"),
                 ("dueling_head", target(de), "probs", "round target",
                  "fp32"))),
             "throughput": (tp, (
                 ("dueling_head", tp.batch_size, None, "learner a*", "fp32"),
                 ("c51_target", tp.batch_size, None, "learner target",
                  "fp32"),
                 ("head_loss", tp.batch_size, None, "learner loss",
                  "fp32"))),
             "bf16": (bf, tuple(
                 (name, b, dist, who, "bf16")
                 for name, b, dist, who in head_shapes(bf)
                 if name != "c51_target"))}
    for phase, (c, shapes) in heads.items():
        timed = [head_times(torch, c, A, shapes) for _ in range(2)]
        log(f"[head times {phase}] " + json.dumps(timed))
        rows += [dict(r, phase=phase)
                 for r in head_rows(torch, c, A, timed, shapes)]
    for phase, c, mdt in (("data-efficient", de, None),
                          ("bf16", bf, torch.bfloat16)):
        shapes = param_shapes(c, A)
        timed = [adam_times(torch, shapes, mdt) for _ in range(2)]
        log(f"[adam times {phase}] " + json.dumps(timed))
        rows.append(dict(adam_row(torch, shapes, timed, mdt), phase=phase))
    for phase, c in (("data-efficient", de), ("throughput", tp)):
        timed = [noise_times(torch, c, A) for _ in range(2)]
        log(f"[noise times {phase}] " + json.dumps(timed))
        rows.append(dict(noise_row(torch, c, A, timed), phase=phase))
    case = (de.num_envs, de_k_last, True, "data-efficient Trainer append, "
            "its last K")
    timed = [kc_times(torch, np, None, [case]) for _ in range(2)]
    log("[kc times data-efficient] " + json.dumps(timed))
    rows.append(dict(kc_row(torch, np, *case, timed),
                     phase="data-efficient"))
    return rows


def kernel_rows(torch, np, cfg, A, counts, shapes, replay_rows,
                delta_last, delta_timed, adam_timed, head_timed, noise_timed,
                kc_timed, k_last, extra_rows, phase_shapes):
    """Time each kernel, its plain version and a library call at the main
    path's shapes (B = envs for the actor's kernels, B = 32 for the
    learner's, the canonical net's ``shapes`` for Adam, the round's noise
    draw for K2, a real delta for K10), and work out each bound from the
    same shapes; K5-K7's rows (``replay_rows``) come timed from
    ring_rows. ``counts`` maps a phase to its launch counts;
    ``launches`` is the trainer phase's (the main path, through cli.main),
    for K10 the side-path trainer's (delta uploads), and the other phases'
    counts are kept beside it. KB's, c51_target's and head_loss's rows come
    from head_rows, timed in ``head_timed``, K2's from ``noise_timed``,
    K10's from ``delta_timed`` (two delta_times), K9's from ``adam_timed``
    (two adam_times), KC's at kc_cases(k_last) from ``kc_timed`` (two
    kc_times). ``extra_rows`` (preset_rows, and the replay phase's rows of
    the presets' rings) each name their ``phase``, whose counts their
    ``launches`` are. Each row's ``launches_at_shape`` is its phase's (the
    main Trainer's without one) launches at the row's ``tally_key`` in
    ``phase_shapes`` (launches by shape, _Watch.shapes)."""
    rows = ka_rows(torch)

    rows += head_rows(torch, cfg, A, head_timed)

    for n, k, with_rep, who in kc_cases(k_last):
        rows.append(kc_row(torch, np, n, k, with_rep, who, kc_timed))
    rows.append(adam_row(torch, shapes, adam_timed))
    rows += replay_rows
    rows += noise_delta_rows(torch, cfg, A, delta_last, delta_timed,
                             noise_timed)
    rows += extra_rows
    for r in rows:
        r.setdefault("flop_dtype", "fp32")
        r["bound_ms"] = bound_ms(r["flops"], r["bytes"], r["flop_dtype"])
        r["bound_by"] = ("bytes" if bound_ms(0, r["bytes"]) >= r["bound_ms"]
                         else "operations")
        _four_product_bound(r)
        r["kernel_ms"] = r["ms"]
        phase = r.get("phase")
        r["launches"] = counts[phase or ("side" if r["name"] == "apply_delta"
                                         else "trainer")][r["name"]]
        r["trainer_launches"] = counts["trainer"][r["name"]]
        r["sequential_launches"] = counts["sequential"][r["name"]]
        r["side_launches"] = counts["side"][r["name"]]
        r["train_launches"] = counts["train"][r["name"]]
        r["actor_launches"] = counts["actor"][r["name"]]
        r["eval_launches"] = counts["evaluate"][r["name"]]
        r["distributed_launches"] = counts["distributed"].get(r["name"], 0)
        r["learning_launches"] = counts["learning"].get(r["name"], 0)
        r["preset_launches"] = {label: counts[label][r["name"]]
                                for label, _ in PRESET_RUNS}
        if "tally_key" in r:
            r["launches_at_shape"] = phase_shapes[phase or "trainer"].get(
                r["tally_key"], 0)
        if r["name"] in ("stratified_sample", "append_framestack"):
            r["one_block_floor_device_ms"] = head_timed[0]["floor"]
    return rows


def noise_row(torch, cfg, A, noise_timed):
    """The row of K2 at ``cfg``'s batched round's launch (the canonical one:
    8192 target rows and 256 online draws, 73.3 M float32), from
    ``noise_timed`` (two noise_times of this run: CUDA graphs, cold and
    warm); its library call is torch.randn of the same count timed the same
    way: the normal draw without the transform."""
    from rainbow_tpu_torch.models.noisy import philox_noise_plain

    nb = cfg.num_envs // cfg.replay_frequency
    shapes = noise_shapes(cfg, A, [(nb * cfg.batch_size,), (nb,)])
    n = sum(torch.Size(s).numel() for s in shapes)
    randn = noise_timed[0]["randn"]
    return dict(name="scaled_noise", route="cuda",
                source="rainbow_tpu_torch/kernels/csrc/noise.cu",
                replaces="rainbow_tpu/models/noisy.py:49",
                shape=f"{len(shapes)} tensors, {n} float32 (round: "
                      f"{nb * cfg.batch_size} target rows + {nb} online "
                      f"draws)",
                tally_key=f"scaled_noise {n} floats",
                **noise_timed[0]["scaled_noise"],
                again=noise_timed[1]["scaled_noise"],
                plain_ms=time_ms(torch, lambda: philox_noise_plain(
                    7, 0, shapes, "cuda"), reps=5),
                library_ms=randn["ms"], library_ms_warm=randn["ms_warm"],
                library_device_ms=randn["device_ms"],
                library_device_ms_warm=randn["device_ms_warm"],
                library_again=noise_timed[1]["randn"],
                library_call="torch.randn, same count",
                # Writes only. Philox: 10 rounds of 2 mulhi, 2 mullo and 4
                # xors plus 9 key bumps per 4 elements (~25 a element);
                # Box-Muller and the transform ~12 a element, counted at
                # the float32 peak (int32 runs slower on the H100).
                flops=37 * n, bytes=4 * n)


def noise_delta_rows(torch, cfg, A, delta_last, delta_timed, noise_timed):
    """Rows of K2 at the batched round's launch (noise_row) and of K10 at
    the last real 1024-env pong delta of pong_delta. K10's times come
    from ``delta_timed`` (two delta_times, the same way); no PyTorch call
    computes K10's strided plane copy with its segmented scatter, so its
    library_ms is null."""
    from rainbow_tpu_torch.train import _apply_delta_plain

    stack, offsets, pos, val = delta_last
    e, plane, h = stack.shape[0], stack.shape[1] * stack.shape[2], \
        stack.shape[3]
    entries = int(pos.shape[0])
    return [
        noise_row(torch, cfg, A, noise_timed),
        dict(name="apply_delta", route="cuda",
             source="rainbow_tpu_torch/kernels/csrc/delta.cu",
             replaces="rainbow_tpu/train.py:176",
             shape=f"N={e} H={h} {entries} entries",
             **delta_timed[0], again=delta_timed[1],
             plain_ms=time_ms(torch, lambda: _apply_delta_plain(
                 stack, offsets, pos, val), before=l2_flush(torch)),
             library_ms=None,
             library_note="no single PyTorch call copies the newest plane "
                          "and scatters the segments",
             # Read the newest plane, the offsets and the entries; write
             # the plane; a compare per entry.
             flops=entries,
             bytes=2 * e * plane + 4 * (e + 1) + 3 * entries,
             # Every 32-byte sector of the interleaved (N, P, H) stack that
             # holds newest-plane bytes holds the other frames too: the
             # whole stack comes in from device memory.
             sector_floor_ms=bound_ms(0, h * e * plane + e * plane
                                      + 4 * (e + 1) + 3 * entries)),
    ]


def head_shapes(cfg):
    """The main path's launches of csrc/head.cu's kernels, as (name, B,
    dist, caller): KB for the learner's double-Q a* (no distribution), for
    the act and for the round's target (probabilities), and c51_target and
    head_loss at the learner's batch."""
    b = cfg.batch_size
    return (("dueling_head", b, None, "learner a*"),
            ("dueling_head", cfg.num_envs, None, "act"),
            ("dueling_head", cfg.num_envs // cfg.replay_frequency * b,
             "probs", "round target"),
            ("c51_target", b, None, "learner target"),
            ("head_loss", b, None, "learner loss"))


def _head_key(name, b, dist, dtn="fp32"):
    """A head kernel's key in head_times: fp32 keys keep no dtype."""
    return f"{name} B={b} {dist}" + ("" if dtn == "fp32" else f" {dtn}")


def _head_inputs(torch, b, A, atoms, dtn="fp32"):
    dt = torch.bfloat16 if dtn == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(21)
    v = torch.randn((b, atoms), generator=g, device="cuda").to(dt)
    a = torch.randn((b, A * atoms), generator=g, device="cuda").to(dt)
    acts = torch.randint(0, A, (b,), generator=g, device="cuda")
    m = torch.softmax(torch.randn((b, atoms), generator=g, device="cuda"),
                      dim=1)
    w = torch.rand((b,), generator=g, device="cuda")
    return v, a, acts, m, w


def _target_args(torch, cfg, b, A):
    """c51_target's arguments at the learner's batch: the target net's
    distribution (softmax of _head_inputs' a), a*, returns in [-2, 2] and
    nonterminals of 1, the configuration's γⁿ and support."""
    from rainbow_tpu_torch.ops.c51 import support_vector

    _, a, acts, _, w = _head_inputs(torch, b, A, cfg.atoms)
    pns = torch.softmax(a.view(b, A, cfg.atoms), dim=2)
    z = support_vector(cfg.v_min, cfg.v_max, cfg.atoms, "cuda")
    return (pns, acts, w * 4 - 2, torch.ones_like(w),
            cfg.discount ** cfg.multi_step, z, cfg.v_min, cfg.v_max)


def head_times(torch, cfg, A, shapes=None):
    """Times of KB, c51_target and head_loss through the wrappers of the
    rainbow_tpu_torch that is imported, at head_shapes(cfg) with A actions
    and the configuration's support, fp32, or at ``shapes`` ((name, B, dist,
    caller, streams' dtype) each): device time per call from CUDA
    graphs, cold (the L2 flushed before each call) and warm, and CUDA event
    time per call, cold and warm. "floor": KB at B = 1 (one block) in a
    graph, warm, the least time one launch of these kernels takes. Returns
    {_head_key(...): {...}, "floor": ms}."""
    from rainbow_tpu_torch.kernels import c51 as k4
    from rainbow_tpu_torch.kernels.dueling_head import dueling_head_fwd
    from rainbow_tpu_torch.ops.c51 import support_vector

    z = support_vector(cfg.v_min, cfg.v_max, cfg.atoms, "cuda")
    flush = l2_flush(torch)
    out = {}
    for name, b, dist, _, *dtn in shapes or head_shapes(cfg):
        v, a, acts, m, w = _head_inputs(torch, b, A, cfg.atoms, *dtn)
        if name == "dueling_head":
            fn = lambda: dueling_head_fwd(v, a, z, A, dist)
        elif name == "c51_target":
            args = _target_args(torch, cfg, b, A)
            fn = lambda: k4.c51_target(*args)
        else:
            fn = lambda: k4.head_loss(v, a, acts, m, w)
        out[_head_key(name, b, dist, *dtn)] = graphed_times(torch, fn, flush)
    v, a = _head_inputs(torch, 1, A, cfg.atoms)[:2]
    out["floor"] = graph_ms(torch, lambda: dueling_head_fwd(v, a, z, A, None),
                            n=40, reps=21)
    return out


def graphed_times(torch, fn, flush):
    """One call of ``fn``: its device time from CUDA graphs and its CUDA
    event time, each cold (``flush`` before each call) and warm. A cold
    call's device time is the difference of two replays that each hold 40
    flushes of 128 MB: many replays steady it."""
    return dict(ms=time_ms(torch, fn, before=flush),
                ms_warm=time_ms(torch, fn),
                device_ms=graph_ms(torch, fn, before=flush, n=40, reps=21),
                device_ms_warm=graph_ms(torch, fn, n=40, reps=21))


def delta_times(torch, stack, offsets, pos, val):
    """K10's times on one delta through the wrapper of the rainbow_tpu_torch
    that is imported, by graphed_times, and its device time cold after
    l2_clean_flush (``device_ms_clean_l2``). Cold, the 29 MB stack is in
    device memory, as on the Trainer's path: the act of the iteration
    before runs between the stack's last write (its append) and K10, and
    its float conversion of the stack writes 115 MB, more than the 50 MB
    L2. After l2_flush K10's reads of the stack also write back as many
    bytes of the flush's dirty lines; after l2_clean_flush they do not,
    which is the traffic of the sector floor. Beside it, timed the same
    way (``plane_copy``), torch's copy of the newest plane alone,
    ``stack[..., -1].contiguous()``, which moves the same sectors without
    the scatter: a yardstick, not a library call for the function."""
    from rainbow_tpu_torch.kernels.delta import apply_delta

    k10 = lambda: apply_delta(stack, offsets, pos, val)
    flush = l2_flush(torch)
    return dict(graphed_times(torch, k10, flush),
                device_ms_clean_l2=graph_ms(torch, k10,
                                            before=l2_clean_flush(torch),
                                            n=40, reps=21),
                plane_copy=graphed_times(
                    torch, lambda: stack[..., -1].contiguous(), flush))


def adam_times(torch, shapes, mu_dtype=None, layout="separate"):
    """K9's times over a net's ``shapes`` with a float32 mu (or
    ``mu_dtype``) through the wrapper of the rainbow_tpu_torch that is
    imported, and the library's (clip_grad_norm_ with foreach, then a fused
    Adam, capturable so that a CUDA graph holds it; its moments are
    float32), each by graphed_times. Returns {"clip_adam": {...},
    "library": {...}}."""
    from rainbow_tpu_torch.kernels.adam import clip_adam

    p, grads, mu, nu, count = adam_inputs(torch, shapes, mu_dtype, layout)
    leaves = [torch.nn.Parameter(t.clone()) for t in p]
    for t, gr in zip(leaves, grads):
        t.grad = gr.clone()
    lr, b1, b2, eps, clip = ADAM_HYPER
    opt = torch.optim.Adam(leaves, lr=lr, betas=(b1, b2), eps=eps,
                           fused=True, capturable=True)

    def library():
        torch.nn.utils.clip_grad_norm_(leaves, clip, foreach=True)
        opt.step()
    flush = l2_flush(torch)
    return {"clip_adam": graphed_times(
                torch, lambda: clip_adam(p, grads, mu, nu, count,
                                         *ADAM_HYPER), flush),
            "library": graphed_times(torch, library, flush)}


def noise_times(torch, cfg, A):
    """K2's times through the rainbow_tpu_torch that is imported, at
    ``cfg``'s batched round's draw (noise_shapes with the round's target
    rows and its online draws: 8192 and 256 in the canonical one), by
    graphed_times, beside torch.randn of the same count timed the same way
    ("randn"). Returns {"scaled_noise": {...}, "randn": {...}}."""
    from rainbow_tpu_torch.kernels.noise import scaled_noise

    nb = cfg.num_envs // cfg.replay_frequency
    shapes = noise_shapes(cfg, A, [(nb * cfg.batch_size,), (nb,)])
    n = sum(torch.Size(s).numel() for s in shapes)
    flush = l2_flush(torch)
    return {"scaled_noise": graphed_times(
                torch, lambda: scaled_noise(7, 0, shapes, "cuda"), flush),
            "randn": graphed_times(
                torch, lambda: torch.randn(n, device="cuda"), flush)}


def head_rows(torch, cfg, A, timed, shapes=None):
    """Rows of KB at its three main-path shapes and of c51_target and
    head_loss at the learner's batch, or at ``shapes`` (as head_times'),
    from ``timed`` (two head_times of
    this run), with the plain version (cold) and KB's library yardstick:
    softmax, the Σ z·p and the argmax (three calls on precombined logits;
    no one PyTorch call computes the head, the projection or the loss),
    timed as the kernel is: device time from CUDA graphs, cold and warm,
    beside its CUDA event time (head_loss's cross-entropy yardstick the
    same way). Each row states the one-block floor beside its bound and its key in a
    Trainer's launches by shape (``tally_key``)."""
    import torch.nn.functional as F

    from rainbow_tpu_torch.ops import c51 as oc51
    from rainbow_tpu_torch.ops.head import dueling_head_plain

    n = cfg.atoms
    z = oc51.support_vector(cfg.v_min, cfg.v_max, n, "cuda")
    flush = l2_flush(torch)
    rows = []
    for name, b, dist, who, *dtn in shapes or head_shapes(cfg):
        dtn = (dtn or ["fp32"])[0]
        key = _head_key(name, b, dist, dtn)
        sb = 2 if dtn == "bf16" else 4  # bytes of a stream element
        v, a, acts, m, w = _head_inputs(torch, b, A, n, dtn)
        row = dict(name=name, route="cuda",
                   source="rainbow_tpu_torch/kernels/csrc/head.cu",
                   shape=f"B={b} A={A} atoms={n} {dist or 'no dist'} {dtn} "
                         f"({who})",
                   **timed[0][key], again=timed[1][key],
                   one_block_floor_device_ms=timed[0]["floor"],
                   flop_dtype=dtn,
                   tally_key=(f"c51_target B={b}" if name == "c51_target"
                              else f"head_loss B={b} {dtn}"
                              if name == "head_loss"
                              else f"dueling_head B={b} {dist} {dtn}"))
        if name == "c51_target":
            args = _target_args(torch, cfg, b, A)
            row.update(
                replaces="rainbow_tpu/ops/c51.py:28",
                plain_ms=time_ms(torch, lambda: oc51.c51_target_plain(*args),
                                 before=flush),
                library_ms=None,
                # What the projection needs, not the kernel's dense
                # atoms × atoms form: per source atom Tz (2 ops), clip (2),
                # b (2), floor, the fraction, the two weights (3) and the
                # two scatter-adds (2).
                flops=13 * b * n,
                # Read p at a*, the returns, the nonterminals, a* (int64)
                # and the support; write m.
                bytes=4 * (b * n + 2 * b + n + b * n) + 8 * b)
        elif name == "dueling_head":
            logits = (v.view(b, 1, n) + a.view(b, A, n)
                      - a.view(b, A, n).mean(1, keepdim=True))
            library = lambda: (torch.softmax(logits, dim=2) * z).sum(
                dim=2).argmax(dim=1)
            row.update(
                replaces="rainbow_tpu/models/dqn.py:148",
                plain_ms=time_ms(torch, lambda: dueling_head_plain(
                    v, a, z, A, dist), before=flush),
                library_ms=time_ms(torch, library, before=flush),
                library_device_ms=graph_ms(torch, library, before=flush,
                                           n=40, reps=21),
                library_device_ms_warm=graph_ms(torch, library, n=40,
                                                reps=21),
                library_call="softmax, Σ z·p, argmax on combined logits",
                flops=b * A * n * 10,
                # Read v, a and z, write q, the action and max q, and the
                # (B, A, atoms) probabilities when asked for.
                bytes=sb * (b * n + b * A * n) + 4 * (n + b * A + b) + 8 * b
                + (4 * b * A * n if dist else 0))
        else:
            aa = a.view(b, A, n)
            q_a = (v[:, None] + aa - aa.mean(1, keepdim=True))[
                torch.arange(b, device="cuda"), acts]
            m_a = m.to(q_a.dtype)
            yardstick = lambda: F.cross_entropy(q_a, m_a, reduction="none")
            row.update(
                replaces="rainbow_tpu/ops/c51.py:57",
                plain_ms=time_ms(torch, lambda: oc51.head_loss_plain(
                    v, a, acts, m, w), before=flush),
                # No one call computes the combine, the weighted loss and
                # its gradient; the nearest, timed beside it, is the loss
                # alone on the chosen action's combined logits.
                library_ms=None,
                yardstick="F.cross_entropy with probability targets on the "
                "chosen action's combined logits (the loss alone: no "
                "dueling combine, IS weights or gradient)",
                yardstick_ms=time_ms(torch, yardstick, before=flush),
                yardstick_device_ms=graph_ms(torch, yardstick, before=flush,
                                             n=40, reps=21),
                yardstick_device_ms_warm=graph_ms(torch, yardstick, n=40,
                                                  reps=21),
                flops=b * A * n * 4 + b * n * 12,
                # Read v, a, m, w and the actions, write dv, da, the losses
                # and the loss.
                bytes=sb * (2 * b * n + 2 * b * A * n)
                + 4 * (b * n + 2 * b + 1) + 8 * b)
        rows.append(row)
    return rows


def ka_kernels(direction, dt, plan):
    """The kernels of csrc/noisy_linear.cu that one KA call launches under
    ``plan``: float32 on the CUDA cores, bf16 on the tensor cores (mma.sync),
    each with its ordered reduce when the plan splits."""
    import torch

    bf16 = dt in (torch.bfloat16, "bf16")
    if direction == "fwd":
        main = ("noisy_linear_fwd_mma" if bf16
                else f"noisy_linear_fwd_{plan.path}")
        reduce = "noisy_linear_fwd_reduce"
    elif plan.path == "large":
        main, reduce = "noisy_linear_bwd_large", "noisy_linear_bwd_large_reduce"
        return main + (f" + {reduce}" if max(plan.splits, plan.w_splits) > 1
                       else "")
    else:
        main = "noisy_linear_bwd_mma" if bf16 else "noisy_linear_bwd_kernel"
        reduce = "noisy_linear_dx_reduce"
    return main + (f" + {reduce}" if plan.splits > 1 else "")


# KA's rows at the main path's shapes: (direction, B, in, out, noise mode,
# dtype, caller), fc_h_* with its ReLU, where KA moves the most.
KA_ROWS = (("fwd", 32, 3136, 512, "shared", "fp32", "learner"),
           ("fwd", 8192, 3136, 512, "row", "fp32", "target"),
           ("fwd", 1024, 3136, 512, "row", "fp32", "actor"),
           ("bwd", 32, 3136, 512, "shared", "fp32", "learner"),
           ("bwd", 256, 3136, 512, "shared", "fp32", "throughput learner"),
           ("bwd", 1024, 3136, 512, "shared", "fp32", "batch-1024 learner"))


def ka_rows(torch, cases=KA_ROWS):
    """Rows of KA at ``cases`` (KA_ROWS by default: fc_h_*, 3136 -> 512 with
    its ReLU, fp32, the layer that moves the most: its forward at the
    learner's B = 32 with shared noise, at the round's 8192-row target
    forward and at the actor's B = 1024 with per-row noise, and its backward
    at B = 32, 256 and 1024 with shared noise; a backward row with no or
    shared noise is bounded by the two products the function needs,
    ``bound_ms_four_products`` by the four-product count beside it). Each is
    timed cold (the L2 flushed ahead of every call: the weights, 25.7 MB,
    would fit in it) and warm, by CUDA events and on the device, beside
    its library yardstick (``addmm`` x 2 for the forward: the two products
    with their biases, no eps_out; ``mm`` x 4 for the backward; in bf16 on
    bf16 copies of the weights) timed the
    same way: the two device times decide "slower than its library call".
    The plain
    version is timed cold. Each row names its key in a Trainer's launches
    by shape (``tally_key``). Device times
    come from CUDA graphs (graph_ms); the profiler's reading is kept beside
    them, since late in a long run it has read below what the events
    allow."""
    import dataclasses

    from rainbow_tpu_torch.kernels.noisy_linear import (bwd_plan, fwd_plan,
                                                        noisy_linear_bwd,
                                                        noisy_linear_fwd)
    from rainbow_tpu_torch.models.noisy import (NoiseStream,
                                                init_noisy_params,
                                                noisy_linear_bwd_plain,
                                                noisy_linear_plain,
                                                scale_noise)

    g = torch.Generator(device="cuda").manual_seed(18)
    ns = NoiseStream(18)
    flush = l2_flush(torch)
    source = "rainbow_tpu_torch/kernels/csrc/noisy_linear.cu"

    def timed(kernel, plain, library):
        cold = dict(before=flush)
        return dict(
            ms=time_ms(torch, kernel, **cold), ms_warm=time_ms(torch, kernel),
            device_ms=graph_ms(torch, kernel, **cold),
            device_ms_warm=graph_ms(torch, kernel),
            profiler_device_ms=device_ms(torch, kernel, only="noisy_linear",
                                         **cold),
            plain_ms=time_ms(torch, plain, **cold),
            library_ms=time_ms(torch, library, **cold),
            library_ms_warm=time_ms(torch, library),
            library_device_ms=graph_ms(torch, library, **cold),
            library_device_ms_warm=graph_ms(torch, library),
            library_profiler_device_ms=device_ms(torch, library, **cold))

    rows, layers = [], {}
    for direction, b, n_in, n_out, mode, dtn, who in cases:
        if (n_in, n_out) not in layers:
            layers[(n_in, n_out)] = init_noisy_params(g, n_in, n_out, 0.1)
        prm = layers[(n_in, n_out)]
        w = (prm["weight_mu"], prm["weight_sigma"])
        dt = torch.bfloat16 if dtn == "bf16" else torch.float32
        xb = 2 if dtn == "bf16" else 4
        wl = [t.to(dt) for t in w]  # the library's operands
        bl = [prm["bias_mu"].to(dt), prm["bias_sigma"].to(dt)]
        x = torch.rand((b, n_in), generator=g, device="cuda").to(dt)
        row_eps = mode == "row"
        lead = (b,) if row_eps else ()
        eps = (scale_noise(ns, lead + (n_in,), "cuda"),
               scale_noise(ns, lead + (n_out,), "cuda"))
        xe = x * eps[0].to(dt)
        key = f"noisy_linear_{direction} B={b} {n_in}->{n_out} {mode}"
        row = dict(
            name=f"noisy_linear_{direction}", route="cuda", source=source,
            replaces="rainbow_tpu/models/noisy.py:57",
            shape=f"B={b} {n_in}->{n_out} {mode} eps {dtn} relu ({who})",
            tally_key=f"{key} {dtn}", flop_dtype=dtn)
        if direction == "fwd":
            plan = fwd_plan(b, n_in, n_out, 2 if row_eps else 1, dt)
            row.update(
                plan=dataclasses.asdict(plan),
                kernels=ka_kernels(direction, dt, plan),
                **timed(lambda: noisy_linear_fwd(prm, x, eps, True),
                        lambda: noisy_linear_plain(prm, x, eps, True),
                        lambda: (torch.addmm(bl[0], x, wl[0].t()),
                                 torch.addmm(bl[1], xe, wl[1].t()))),
                library_call="addmm x 2",
                flops=4 * b * n_in * n_out + b * n_in + 6 * b * n_out,
                bytes=xb * b * (n_in + n_out)
                + 4 * ((b if row_eps else 1) * (n_in + n_out)
                       + 2 * n_in * n_out + 2 * n_out))
        else:
            gy = torch.randn((b, n_out), generator=g, device="cuda").to(dt)
            y = noisy_linear_fwd(prm, x, eps, True)
            ge = gy * eps[1].to(dt)
            plan = bwd_plan(b, n_in, n_out, 2 if row_eps else 1, dt)
            row.update(
                plan=dataclasses.asdict(plan),
                kernels=ka_kernels(direction, dt, plan),
                **timed(lambda: noisy_linear_bwd(*w, x, gy, eps, y),
                        lambda: noisy_linear_bwd_plain(*w, x, gy, eps, y),
                        lambda: (torch.mm(gy, wl[0]), torch.mm(ge, wl[1]),
                                 torch.mm(gy.t(), x), torch.mm(ge.t(), xe))),
                library_call="mm x 4",
                # Per-row noise takes four products; no or shared noise two
                # (dx over W_eff and dmu_w; dsigma_w is dmu_w scaled by
                # eps_out eps_in^T), whatever path runs them. The
                # four-product count stays beside it.
                flops=(4 if row_eps else 2) * 2 * b * n_in * n_out
                + 3 * b * n_out + 3 * b * n_in,
                **({} if row_eps else dict(
                    flops_four_products=8 * b * n_in * n_out + 3 * b * n_out
                    + 3 * b * n_in)),
                bytes=xb * 2 * b * (n_in + n_out)
                + 4 * (4 * n_in * n_out + n_in + 3 * n_out))
        rows.append(row)
        del x, eps, xe
    return rows


def adam_row(torch, shapes, timed, mu_dtype=None, layout="separate"):
    """The row of clip + Adam over a net's ``shapes`` with a float32 mu (or
    ``mu_dtype``), from ``timed`` (two adam_times of this run: CUDA graphs,
    cold and warm, the library's beside it)."""
    from rainbow_tpu_torch.agent import apply_grads_plain
    from rainbow_tpu_torch.kernels.adam import clip_adam

    n = sum(torch.Size(s).numel() for s in shapes)
    p, grads, mu, nu, count = adam_inputs(torch, shapes, mu_dtype, layout)
    mdt = _dt(mu[0])
    lib = timed[0]["library"]
    # The profiler's device time of each of the call's two launches (the
    # norm's pass and the update's; adam_kernel before the update pass had
    # its name), per call, cold.
    split = {}
    for name, us in _kernel_us(torch, lambda: clip_adam(
            p, grads, mu, nu, count, *ADAM_HYPER), 20,
            l2_flush(torch)).items():
        for kernel in ("sumsq_kernel", "update_kernel", "adam_kernel"):
            if kernel in name:
                split[kernel] = split.get(kernel, 0.0) + us / 20 / 1e3
    return dict(
        name="clip_adam", route="cuda",
        source="rainbow_tpu_torch/kernels/csrc/adam.cu",
        replaces="rainbow_tpu/agent.py:212",
        shape=f"{n} params in {len(shapes)} tensors, {mdt} mu"
        + (", grads as views of one flat buffer" if layout == "flat" else ""),
        tally_key=f"clip_adam {n} params mu {mdt}",
        **timed[0]["clip_adam"], again=timed[1]["clip_adam"],
        profiler_device_ms_by_launch=split,
        plain_ms=time_ms(torch, lambda: apply_grads_plain(
            p, grads, mu, nu, count, *ADAM_HYPER)),
        library_ms=lib["ms"], library_ms_warm=lib["ms_warm"],
        library_device_ms=lib["device_ms"],
        library_device_ms_warm=lib["device_ms_warm"],
        library_again=timed[1]["library"],
        library_call="clip_grad_norm_(foreach) + Adam(fused, capturable), "
                     "float32 moments",
        # Read p, g, mu and nu once, write p, mu and nu once: the norm's
        # second read of g (27.5 MB) can come from the 50 MB L2.
        flops=20 * n, bytes=4 * n * 5 + 2 * n * mu[0].element_size())


# ---------------------------------------------------------------- main -----


def gather_digests(torch, rep, nb, bs, n, seed):
    """SHA-256 of every output of K6 (each field and the whole window) for
    ``nb`` batches of ``bs`` draws with n-step ``n`` on the ring ``rep``,
    through the imported wrappers, from uniforms of ``seed`` (K5 draws
    them, bit for bit its plain version)."""
    from rainbow_tpu_torch.kernels import replay as k_replay

    g = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.rand(nb * bs, generator=g, device="cuda")
    idx, p, total = k_replay.stratified_sample(rep, u, 4, n)
    out = k_replay.gather_window(rep, idx, p, total, 0.6, nb, bs, 4, n, 0.99)
    torch.cuda.synchronize()
    digests = {k: sha256(torch, [v]) for k, v in sorted(out.items())
               if k not in ("states", "next_states")}
    digests["window"] = sha256(torch, [out["states"]._base])
    return digests


def adam_ab_rows(torch, cfg, presets, A):
    """K9's rows (adam_row, timed twice by adam_times) at the canonical net
    with a float32 and a bf16 mu, at the data-efficient net, and at the
    canonical net with its grads as views of one flat buffer (the
    data-parallel round's), each with adam_digests."""
    rows = []
    for phase, c, mdt, layout in (
            (None, cfg, None, "separate"),
            ("bf16", presets["bf16"], torch.bfloat16, "separate"),
            ("data-efficient", presets["data-efficient"], None, "separate"),
            ("data-parallel", cfg, None, "flat")):
        shapes = param_shapes(c, A)
        timed = [adam_times(torch, shapes, mdt, layout) for _ in range(2)]
        rows.append(dict(adam_row(torch, shapes, timed, mdt, layout),
                         phase=phase,
                         digests=adam_digests(torch, shapes, mdt, layout)))
    return rows


def gather_ab_rows(torch, cfg, presets):
    """K6's rows (replay_kernel_rows, timed twice by replay_times) at the
    canonical round (256 x 32, window 7) and the throughput preset's (32 x
    256) on the canonical ring, and at the data-efficient preset's (16 x
    32, window 24) on its whole ring, random rings as ring_rows and
    preset_ring_rows make them, each with gather_digests."""
    rows = []
    de, tp = presets["data-efficient"], presets["throughput"]
    for ring_cfg, e, seed, runs in (
            (cfg, ENVS, 20, ((None, cfg), ("throughput", tp))),
            (de, de.num_envs, 24, (("data-efficient", de),))):
        rep, g = _replay_on_card(torch, e, ring_cfg.capacity_per_env, seed)
        rep.index.fill_(500)
        rep.full.fill_(True)
        for phase, c in runs:
            nb, bs = e // c.replay_frequency, c.batch_size
            timed = [replay_times(torch, c, rep, g, ("gather_window",),
                                  seq=False) for _ in range(2)]
            row, = replay_kernel_rows(torch, rep, g, nb, bs, c.multi_step,
                                      timed, ("gather_window",), seq=False)
            rows.append(dict(row, phase=phase, digests=gather_digests(
                torch, rep, nb, bs, c.multi_step, seed + 1)))
        del rep
        torch.cuda.empty_cache()
    return rows


def _four_product_bound(row):
    """A shared-noise KA backward row's bound by the four-product count
    (8·B·IN·OUT operations), beside ``bound_ms`` by the two products the
    function needs."""
    if "flops_four_products" in row:
        row["bound_ms_four_products"] = bound_ms(
            row["flops_four_products"], row["bytes"],
            row.get("flop_dtype", "fp32"))


TIME_ROWS = ("ka", "adam", "gather")


def time_rows(kind, tree, label) -> int:
    """--time-rows: one kernel's rows with the package of ``tree``, into
    OUT_DIR/<kind>_times_<label>.json: ``ka`` ka_rows at KA_ROWS in float32
    and bf16; ``adam`` adam_ab_rows; ``gather`` gather_ab_rows. Device
    times from CUDA graphs (cold and warm) beside the library calls', where
    there are any; K9's and K6's rows also hold the SHA-256 of their
    outputs on inputs from a seed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check(kind in TIME_ROWS, f"--time-rows: {kind} is not one of {TIME_ROWS}")
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import rainbow_tpu_torch
    check(rainbow_tpu_torch.__file__.startswith(tree),
          f"--time-rows: imported {rainbow_tpu_torch.__file__}, not {tree}'s")
    from rainbow_tpu_torch import canonical

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    cfg = canonical(game=GAME, num_envs=ENVS, seed=SEED)
    presets = preset_configs()
    if kind == "ka":
        bf16 = tuple(c[:5] + ("bf16",) + c[6:] for c in KA_ROWS)
        rows = ka_rows(torch, KA_ROWS + bf16)
        for r in rows:
            r.pop("kernels")  # this script's names, not necessarily the tree's
    elif kind == "adam":
        rows = adam_ab_rows(torch, cfg, presets, PONG_ACTIONS)
    else:
        rows = gather_ab_rows(torch, cfg, presets)
    for r in rows:
        r["bound_ms"] = bound_ms(r["flops"], r["bytes"],
                                 r.get("flop_dtype", "fp32"))
        _four_product_bound(r)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = dict(tree=tree, label=label, kind=kind, card=smi, rows=rows)
    with open(os.path.join(OUT_DIR, f"{kind}_times_{label}.json"), "w") as f:
        json.dump(out, f, indent=1)
    log(f"[{kind} times {label}] {smi} " + json.dumps(
        {f'{r["name"]} {r["shape"]}': [r["device_ms"], r["device_ms_warm"],
                                       r.get("library_device_ms")]
         for r in rows}))
    return 0


def main() -> int:
    args = parse_args()
    if args.rank is not None:
        return distributed_rank(args)
    if args.time_rows:
        return time_rows(*args.time_rows)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import rainbow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the rainbow_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 1
    import numpy as np

    os.chdir(ROOT)  # the Trainer writes results/<id>/ relative to here
    from rainbow_tpu_torch import canonical
    from rainbow_tpu_torch import evaluate as ev
    from rainbow_tpu_torch.envs import engine
    from rainbow_tpu_torch.kernels import build, launches, reset_launches
    from rainbow_tpu_torch.models.dqn import init_dqn_params
    from rainbow_tpu_torch.models.noisy import NoiseStream
    from rainbow_tpu_torch.train import make_env_factory

    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "log.txt"), "w").close()
    t_start = time.perf_counter()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")

    # 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    engine_err = []

    def build_engine():
        try:
            engine._lib = engine._load_lib()
        except Exception as e:  # re-raised below, on the main thread
            engine_err.append(e)
    th = threading.Thread(target=build_engine)
    th.start()
    logs = build.build_all()
    nvcc_s = time.perf_counter() - t0
    th.join()
    if engine_err:
        raise engine_err[0]
    for name, text in logs.items():
        with open(os.path.join(OUT_DIR, f"nvcc_{name}.log"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    log(f"[build] nvcc {nvcc_s:.1f} s (all sources in parallel), engine "
        f"ready after {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    smi_line = smi[0] if smi else ""
    log(smi_line)

    # Full fp32 matrix products and convolutions for the whole run: the
    # card tests compare at full precision, and the timed phases compute at
    # the precision the configuration states (compute_dtype float32), not
    # in TF32. The bf16 library calls timed beside KA's rows sum in fp32 and
    # round once, as KA does: cuBLAS's split-K otherwise rounds each partial
    # sum to bf16.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # 2. card tests ---------------------------------------------------------
    run_card_tests(torch)

    # 3. replay rings ------------------------------------------------------
    cfg = canonical(game=GAME, num_envs=ENVS, seed=SEED)
    probe = engine.BatchedEnv(GAME, 1, 0)
    A = probe.action_space
    probe.close()
    presets = preset_configs()
    shapes = param_shapes(cfg, A)
    # Early in the run, where the profiler's split of K5's two launches
    # agrees with the graphs.
    replay_rows = ring_rows(torch, cfg, presets["throughput"])
    de_replay_rows = preset_ring_rows(torch, presets["data-efficient"])
    delta_last = pong_delta(torch, np, cfg)

    # 4. actor ---------------------------------------------------------------
    noise = NoiseStream(SEED)
    params = init_dqn_params(cfg, A, SEED, "cuda")
    stats = run_actor(torch, cfg, params, A, noise)
    log("[actor] " + json.dumps(stats))
    torch.cuda.empty_cache()

    # 5. evaluate ------------------------------------------------------------
    ecfg = cfg.replace(max_episode_length=EVAL_FRAMES,
                       evaluation_episodes=10, evaluation_size=500)
    factory = make_env_factory(ecfg)
    t0 = time.perf_counter()
    reset_launches()
    val_states = ev.build_validation_states(ecfg, factory, "cuda")
    t1 = time.perf_counter()
    fill_steps = launches()["append_framestack"]
    mean_r, mean_q, rewards, qs = ev.evaluate(
        ecfg, params, A, factory, val_states,
        torch.Generator(device="cuda").manual_seed(SEED + 1))
    torch.cuda.synchronize()
    eval_counts = launches()
    eval_s = time.perf_counter() - t1
    # One frame-stack launch per evaluation step (run_episodes). The rate is
    # over all of evaluate(), the episodes and the validation-Q probe: the
    # time an evaluation holds the card.
    eval_steps = eval_counts["append_framestack"] - fill_steps
    check(val_states.shape == (500, 84, 84, 4), "validation states shape")
    check(len(rewards) == 10 and len(qs) == 500, "evaluate output sizes")
    check(np.isfinite(mean_r) and np.isfinite(mean_q) and
          np.isfinite(qs).all(), "evaluate: non-finite result")
    check(all(eval_counts[k] > 0 for k in ("noisy_linear_fwd",
                                           "dueling_head",
                                           "append_framestack")),
          f"evaluate: a kernel never launched {eval_counts}")
    log("[evaluate] " + json.dumps({
        "episodes": 10, "max_episode_length": EVAL_FRAMES,
        "mean_reward": mean_r, "mean_q": mean_q,
        "validation_states_s": t1 - t0, "evaluate_s": eval_s,
        "eval_steps": eval_steps, "eval_steps_per_s": eval_steps / eval_s,
        "launches": eval_counts}))
    if args.profile:
        profile_actor(torch, cfg, params, A, noise)
    del params, val_states
    torch.cuda.empty_cache()

    # 6. train ---------------------------------------------------------------
    train_stats, train_counts = run_train(torch, np, cfg, A, args.profile)
    log("[train] " + json.dumps(train_stats))
    torch.cuda.empty_cache()

    # 7. trainer -------------------------------------------------------------
    trainer_stats, trainer_counts = run_trainer(torch, np)
    log("[trainer] " + json.dumps(trainer_stats))
    seq_stats, seq_counts = run_side_trainer(torch, np, SEQUENTIAL_ARGS,
                                             sync=True)
    log("[trainer sequential] " + json.dumps(seq_stats))
    pipe_stats, _ = run_side_trainer(torch, np, PIPELINE_ARGS, sync=False)
    log("[trainer pipeline] " + json.dumps(pipe_stats))
    side_stats, side_counts = run_side_trainer(torch, np, SIDE_ARGS,
                                               sync=False)
    log("[trainer side] " + json.dumps(side_stats))
    # Like for like: the pipelined actor alone against the main Trainer's
    # span less its evaluation and save; the side run, whose asynchronous
    # evaluation runs inside its span, against the main span with the
    # evaluation in it.
    rate = lambda st, key: st[key + "env_steps_per_s"]
    log("[trainer compare] " + json.dumps({
        "pipeline_vs_main": rate(pipe_stats, "train_")
        / rate(trainer_stats, "train_"),
        "side_vs_main_with_eval": rate(side_stats, "train_")
        / rate(trainer_stats, "train_with_eval_")}))

    # 7b. the other configurations' Trainers, and learning ------------------
    preset_counts, phase_shapes, preset_stats = {}, {}, {}
    for label, args in PRESET_RUNS:
        st, preset_counts[label], phase_shapes[label] = run_preset_trainer(
            torch, np, label, args)
        log(f"[trainer {label}] cuts: {CUTS[label]}")
        log(f"[trainer {label}] " + json.dumps(st))
        preset_stats[label] = st
    learn_stats, learn_counts = run_learning(torch, np)
    log("[learning] " + json.dumps(learn_stats))

    # 8. distributed -------------------------------------------------------
    torch.cuda.empty_cache()
    dist_stats, dist_counts = run_distributed(torch, np, cfg, A)
    log("[distributed] " + json.dumps(dist_stats))

    # 9. kernels line --------------------------------------------------------
    # KB's, c51_target's, head_loss's and K2's times, each taken twice.
    head_timed = [head_times(torch, cfg, A), head_times(torch, cfg, A)]
    log("[head times] " + json.dumps(head_timed))
    noise_timed = [noise_times(torch, cfg, A), noise_times(torch, cfg, A)]
    log("[noise times] " + json.dumps(noise_timed))
    k_last = trainer_stats["kc_last_k"]
    kc_timed = [kc_times(torch, np, k_last), kc_times(torch, np, k_last)]
    log("[kc times] " + json.dumps(kc_timed))
    delta_timed = [delta_times(torch, *delta_last) for _ in range(2)]
    log("[delta times] " + json.dumps(delta_timed))
    adam_timed = [adam_times(torch, shapes) for _ in range(2)]
    log("[adam times] " + json.dumps(adam_timed))
    extra = de_replay_rows + preset_rows(
        torch, np, A, presets,
        preset_stats["data-efficient"]["kc_last_k_by_n"][
            presets["data-efficient"].num_envs])
    rows = kernel_rows(torch, np, cfg, A, {
        "actor": stats["launches"], "evaluate": eval_counts,
        "train": train_counts, "trainer": trainer_counts,
        "sequential": seq_counts, "side": side_counts,
        "distributed": dist_counts, "learning": learn_counts,
        **preset_counts},
        shapes, replay_rows, delta_last, delta_timed, adam_timed, head_timed,
        noise_timed, kc_timed, k_last, extra,
        {"trainer": trainer_stats["launches_by_shape"], **phase_shapes})
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(smi_line)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
