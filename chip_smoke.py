#!/usr/bin/env python3
"""Drive the PyTorch port (rainbow_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a nonzero
exit code:

1. build    nvcc builds the CUDA kernels (one process per source, started
            together) into rainbow_tpu_torch/_build/, while make builds the
            native Atari engine.
2. compare  every kernel against its plain PyTorch version on the card, at
            the shapes the acting path gives it, with stated tolerances.
3. actor    the canonical preset on the native engine (pong, 1024 envs, the
            full 976-column replay ring on the device, per-env noise):
            actor_step_packed iterations, env-steps/s, launch counts.
4. evaluate build_validation_states + evaluate(): ε-greedy episodes and the
            validation-Q probe, launch counts.
5. kernels  each kernel's time against its plain version, a library call
            and its bound, at the actor's shapes; one JSON line.

The last line is {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside it, the script exits nonzero and prints no
result. Longer logs go to chiprun_out/chip_smoke/.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
GAME, ENVS, SEED = "pong", 1024, 0
ACTOR_ITERS = 200
EVAL_FRAMES = 4000  # max_episode_length of the evaluation episodes

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# float32 on the CUDA cores (the kernels here use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


class Failed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def log(*a):
    print(*a, flush=True)


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also trace 20 actor iterations with torch.profiler "
                   "into chiprun_out/chip_smoke/")
    return p.parse_args()


# --------------------------------------------------------------- timing ----

def time_ms(torch, fn, reps=30, warmup=3):
    """Median over ``reps`` of one call's CUDA-event time, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- compare -----

def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(name, got, want, atol, rtol):
    """|got - want| <= atol + rtol·|want| everywhere; returns max |diff|."""
    diff = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = float((diff - bound).max())
    check(worst <= 0, f"{name}: max |diff| {float(diff.max()):.3g} exceeds "
          f"atol {atol} + rtol {rtol}·|ref|")
    return float(diff.max())


def compare_noisy_linear(torch, A, report):
    """KA against noisy_linear_plain: the three noise modes, fp32 and bf16,
    at the acting path's layer shapes and batches. Returns the largest fp32
    error."""
    from rainbow_tpu_torch.models.noisy import (init_noisy_params,
                                                noisy_linear_plain,
                                                scale_noise)
    from rainbow_tpu_torch.kernels.noisy_linear import noisy_linear_fwd

    g = torch.Generator(device="cuda").manual_seed(1)
    # (batch, in, out, relu): the actor (1024), the evaluation episodes (10)
    # and the validation-Q chunks (250) through fc_h_* and fc_z_*.
    shapes = [(b, i, o, r) for b in (1024, 10, 250)
              for i, o, r in ((3136, 512, True), (512, 51, False),
                              (512, A * 51, False))]
    # fp32: both sides sum in fp32 in other orders over up to 3136 terms of
    # O(1) outputs. bf16: the plain version rounds to bf16 after every op
    # (as the JAX package does), the kernel only once at the end, so they
    # differ by a few bf16 ulps (2^-8 relative) of O(1) values.
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6e-2, 3e-2)}
    worst32 = 0.0
    for b, n_in, n_out, relu in shapes:
        params = init_noisy_params(g, n_in, n_out, 0.5)
        x = torch.rand((b, n_in), generator=g, device="cuda") * 2
        for mode in ("mu", "shared", "row"):
            lead = (b,) if mode == "row" else ()
            eps = None if mode == "mu" else (
                scale_noise(g, lead + (n_in,)), scale_noise(g, lead + (n_out,)))
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                got = noisy_linear_fwd(params, xd, eps, relu)
                want = noisy_linear_plain(params, xd, eps, relu)
                check(got.dtype == dt and got.shape == (b, n_out),
                      f"noisy_linear_fwd: output {got.dtype} {tuple(got.shape)}")
                err = check_close(
                    f"noisy_linear_fwd B={b} {n_in}->{n_out} {mode} {dt}",
                    got, want, *tol[dt])
                report.append(("noisy_linear_fwd", b, n_in, n_out, mode,
                               str(dt), err))
                if dt == torch.float32:
                    worst32 = max(worst32, err)
    return worst32


def compare_dueling_head(torch, A, report):
    """KB against dueling_head_plain: no distribution, probs and log-probs,
    fp32 and bf16 streams, at the path's batches. Argmax must agree wherever
    the top-2 gap of q exceeds q's tolerance. Returns the largest error."""
    from rainbow_tpu_torch.ops.c51 import support_vector
    from rainbow_tpu_torch.ops.head import dueling_head_plain
    from rainbow_tpu_torch.kernels.dueling_head import dueling_head_fwd

    g = torch.Generator(device="cuda").manual_seed(2)
    z = support_vector(-10.0, 10.0, 51, "cuda")
    # Both sides combine in the streams' dtype, rounding after each op as
    # PyTorch does, then take an fp32 softmax of the same logits: exp and
    # the sums differ in the last bits only. Probabilities are below 1,
    # log-probs and q of order 10.
    tol = {"probs": 1e-6, "log": 1e-5, "q": 1e-5}
    worst = 0.0
    for b in (1024, 10, 250):
        for n_act in sorted({A, 18}):
            for dt in (torch.float32, torch.bfloat16):
                v = (torch.randn((b, 51), generator=g, device="cuda") * 2).to(dt)
                a = (torch.randn((b, n_act * 51), generator=g,
                                 device="cuda") * 2).to(dt)
                for dist in (None, "probs", "log"):
                    got = dueling_head_fwd(v, a, z, n_act, dist)
                    want = dueling_head_plain(v, a, z, n_act, dist)
                    tag = f"dueling_head B={b} A={n_act} {dt} {dist}"
                    errs = [check_close(tag + " q", got[1], want.q, tol["q"], 0),
                            check_close(tag + " max_q", got[3], want.max_q,
                                        tol["q"], 0)]
                    if dist:
                        errs.append(check_close(tag + " dist", got[0],
                                                want.dist, tol[dist], 0))
                    else:
                        check(got[0] is None, tag + ": wrote a distribution")
                    top2 = want.q.topk(2, dim=1).values
                    clear = top2[:, 0] - top2[:, 1] > tol["q"]
                    check(torch.equal(got[2][clear], want.action[clear]),
                          tag + ": argmax differs where the top-2 gap is clear")
                    check(got[2].dtype == torch.int64, tag + ": argmax dtype")
                    report.append(("dueling_head", b, n_act, str(dt), dist,
                                   max(errs)))
                    worst = max(worst, *errs)
    return worst


def _random_step(torch, np, rng, n, f, h, c, k_frac=0.1):
    """Seeded inputs of one append + frame-stack step, on the CPU."""
    from rainbow_tpu_torch.replay.prioritized import init_replay
    from rainbow_tpu_torch.train import pack_resets

    kinds = np.where(rng.random(n) < k_frac, rng.integers(1, 3, n), 0)
    kinds = kinds.astype(np.uint8)
    resets = rng.integers(0, 256, (n, f, f), np.uint8)
    packed, ridx = pack_resets(resets, kinds)
    rep = init_replay(n, c, f, device="cpu")
    rep.frames.copy_(torch.from_numpy(rng.integers(0, 256, rep.frames.shape,
                                                   np.uint8)))
    rep.timesteps.copy_(torch.from_numpy(rng.integers(0, 9, (n, c), np.int32)))
    rep.t.copy_(torch.from_numpy(rng.integers(0, 9, n, np.int32)))
    rep.index.fill_(c - 1)  # the append wraps the ring
    rep.max_priority.fill_(1.75)
    return dict(
        stack=torch.from_numpy(rng.integers(0, 256, (n, f, f, h), np.uint8)),
        obs=torch.from_numpy(rng.integers(0, 256, (n, f, f), np.uint8)),
        reset_packed=torch.from_numpy(packed),
        reset_idx=torch.from_numpy(ridx),
        kinds=torch.from_numpy(kinds), rep=rep,
        actions=torch.from_numpy(rng.integers(0, 18, n)),
        rewards=torch.from_numpy((rng.normal(size=n) * 3).astype(np.float32)),
        dones=torch.from_numpy(kinds > 0))


def _to(torch, step, dev):
    import dataclasses
    out = {}
    for k, v in step.items():
        if k == "rep":
            out[k] = type(v)(**{f.name: getattr(v, f.name).to(dev).clone()
                                for f in dataclasses.fields(v)})
        else:
            out[k] = v.to(dev).clone()
    return out


def _same_replay(torch, a, b):
    import dataclasses
    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


def compare_append_framestack(torch, np, report):
    """KC against append_framestack_plain, bit-exact: all three reset kinds,
    padded reset indices, reward clipping and a ring wrap, with and without
    a replay, for H = 4 (word path) and H = 3 (byte path)."""
    from rainbow_tpu_torch.ops import preprocess as pp
    from rainbow_tpu_torch.kernels.append_framestack import append_framestack

    rng = np.random.default_rng(3)
    for n, h, c in ((1024, 4, 8), (64, 3, 5)):
        for with_rep in (True, False):
            base = _random_step(torch, np, rng, n, 84, h, c)
            k = _to(torch, base, "cuda")
            p = _to(torch, base, "cuda")
            for step in range(3):  # consecutive steps: the head advances
                obs = torch.from_numpy(rng.integers(0, 256, (n, 84, 84),
                                                    np.uint8)).cuda()
                args = lambda s: (s["stack"], obs, s["reset_packed"],
                                  s["reset_idx"], s["kinds"])
                extra = lambda s: ((s["rep"], s["actions"], s["rewards"],
                                    s["dones"], 1.0) if with_rep else ())
                append_framestack(*args(k), *extra(k))
                pp.append_framestack_plain(*args(p), *extra(p))
                tag = f"append_framestack N={n} H={h} replay={with_rep} step {step}"
                check(torch.equal(k["stack"], p["stack"]), tag + ": stack differs")
                if with_rep:
                    check(_same_replay(torch, k["rep"], p["rep"]),
                          tag + ": replay differs")
                report.append(("append_framestack", n, h, with_rep, step, 0.0))
    return 0.0


# --------------------------------------------------------------- actor -----

def run_actor(torch, cfg, params, A, gen):
    """The acting path on the native engine: returns (stats, stack, rep,
    env, staged inputs of the last step, actions)."""
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
    actions = ag.act(params, cfg, A, to_network_input(stack), gen)
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
        actions = actor_step_packed(params, gen, cfg, A, stack, rep, actions,
                                    *staged)
        actions_np = actions.cpu().numpy()  # the one sync of the step
        iter_s.append(time.perf_counter() - ti)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()

    it = ACTOR_ITERS
    check(counts == {"noisy_linear_fwd": 4 * (it + 1),
                     "dueling_head": it + 1, "append_framestack": it},
          f"actor launch counts {counts}, expected 4/1/1 per iteration "
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
    return stats, stack, rep, env, staged, actions


def check_actor_step_against_plain(torch, np, cfg, params, A, stack, staged,
                                   actions, n=32):
    """One actor iteration through the kernels on the card and through the
    plain versions on the CPU, on the first ``n`` envs of the live state, with
    the same injected per-env noise: stack and replay bit-exact, actions
    equal wherever the top-2 gap of q is clear."""
    from rainbow_tpu_torch.models.dqn import draw_noise, forward_head
    from rainbow_tpu_torch.ops.preprocess import to_network_input
    from rainbow_tpu_torch.replay import prioritized as rp
    from rainbow_tpu_torch.train import actor_step_packed, pack_resets

    obs, packed, ridx, rewards, dones, kinds = (t.cpu() for t in staged)
    resets = np.zeros((obs.shape[0], 84, 84), np.uint8)
    keep = ridx < obs.shape[0]
    resets[ridx[keep].numpy()] = packed[keep].numpy()
    sub_packed, sub_idx = pack_resets(resets[:n], kinds[:n].numpy())
    inputs = (actions[:n].cpu(), obs[:n], torch.from_numpy(sub_packed),
              torch.from_numpy(sub_idx), rewards[:n], dones[:n], kinds[:n])
    noise = draw_noise(cfg, A, torch.Generator().manual_seed(5), (n,))
    out = {}
    for dev in ("cuda", "cpu"):
        st = stack[:n].to(dev).clone()
        rep = rp.init_replay(n, 4, 84, dev)
        p = {k: v.to(dev) for k, v in params.items()}
        ne = {k: (a.to(dev), b.to(dev)) for k, (a, b) in noise.items()}
        act = actor_step_packed(p, None, cfg, A, st, rep,
                                *(t.to(dev) for t in inputs), noise_eps=ne)
        q = forward_head(p, cfg, A, to_network_input(st), noise_eps=ne).q
        out[dev] = (act.cpu(), st.cpu(), rep, q.cpu())
    check(torch.equal(out["cuda"][1], out["cpu"][1]),
          "actor step: stack differs from the plain path")
    check(_same_replay(torch, out["cuda"][2], out["cpu"][2]),
          "actor step: replay differs from the plain path")
    q = out["cpu"][3]
    top2 = q.topk(2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > 1e-4
    check(torch.equal(out["cuda"][0][clear], out["cpu"][0][clear]),
          "actor step: actions differ from the plain path")
    return max_err(out["cuda"][3], q)


def profile_actor(torch, cfg, params, A, gen, iters=20):
    """torch.profiler over ``iters`` actor iterations on a fresh engine and
    a small ring: device time by kernel, and the device's busy share of the
    wall time, into chiprun_out/chip_smoke/."""
    from torch.profiler import ProfilerActivity, profile

    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch.ops.preprocess import (init_framestack,
                                                  to_network_input)
    from rainbow_tpu_torch.replay import prioritized as rp
    from rainbow_tpu_torch.train import (actor_step_packed, make_env_factory,
                                         stage_step)

    env = make_env_factory(cfg)(num_envs=ENVS, training=True)
    stack = init_framestack(ENVS, 4, env.reset_all(), "cuda")
    rep = rp.init_replay(ENVS, 64, 84, "cuda")
    actions = ag.act(params, cfg, A, to_network_input(stack), gen)

    def step(actions):
        out = env.step(actions.cpu().numpy())
        return actor_step_packed(params, gen, cfg, A, stack, rep, actions,
                                 *stage_step(out, "cuda"))
    for _ in range(5):
        actions = step(actions)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            actions = step(actions)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    env.close()
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    with open(os.path.join(OUT_DIR, "actor_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "actor_trace.json"))
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    log("[profile] " + json.dumps({
        "iters": iters, "wall_ms_per_iter": 1e3 * wall / iters,
        "device_busy_ms_per_iter": busy_us / 1e3 / iters,
        "device_busy_share": busy_us / 1e6 / wall}))
    log(table)


# ------------------------------------------------------------- kernels -----

def kernel_rows(torch, np, A, errs, actor_counts, eval_counts, stack, staged):
    """Time each kernel, its plain version and a library call at the actor's
    shapes (B = envs), and work out each bound from the same shapes."""
    from rainbow_tpu_torch.kernels.append_framestack import append_framestack
    from rainbow_tpu_torch.kernels.dueling_head import dueling_head_fwd
    from rainbow_tpu_torch.kernels.noisy_linear import noisy_linear_fwd
    from rainbow_tpu_torch.models.noisy import (init_noisy_params,
                                                noisy_linear_plain,
                                                scale_noise)
    from rainbow_tpu_torch.ops import preprocess as pp
    from rainbow_tpu_torch.ops.c51 import support_vector
    from rainbow_tpu_torch.ops.head import dueling_head_plain
    from rainbow_tpu_torch.replay import prioritized as rp

    g = torch.Generator(device="cuda").manual_seed(4)
    b = stack.shape[0]
    rows = []

    # KA at fc_h_* (3136 -> 512) with per-row noise, the acting path's
    # largest launch (two per iteration).
    n_in, n_out = 3136, 512
    prm = init_noisy_params(g, n_in, n_out, 0.1)
    x = torch.rand((b, n_in), generator=g, device="cuda")
    eps = (scale_noise(g, (b, n_in)), scale_noise(g, (b, n_out)))
    xe = x * eps[0]
    flops = 4 * b * n_in * n_out + b * n_in + 6 * b * n_out
    nbytes = 4 * (2 * b * n_in + 2 * n_in * n_out + 2 * n_out + 2 * b * n_out)
    rows.append(dict(
        name="noisy_linear_fwd", route="cuda",
        source="rainbow_tpu_torch/kernels/csrc/noisy_linear.cu",
        replaces="rainbow_tpu/models/noisy.py:57",
        shape=f"B={b} {n_in}->{n_out} per-row eps fp32 relu",
        ms=time_ms(torch, lambda: noisy_linear_fwd(prm, x, eps, True)),
        plain_ms=time_ms(torch, lambda: noisy_linear_plain(prm, x, eps, True)),
        library_ms=time_ms(torch, lambda: (
            torch.addmm(prm["bias_mu"], x, prm["weight_mu"].t()),
            torch.addmm(prm["bias_sigma"], xe, prm["weight_sigma"].t()))),
        flops=flops, bytes=nbytes))

    # KB at the actor's call: no distribution, q and the greedy action.
    z = support_vector(-10.0, 10.0, 51, "cuda")
    v = torch.randn((b, 51), generator=g, device="cuda")
    a = torch.randn((b, A * 51), generator=g, device="cuda")
    logits = (v.view(b, 1, 51) + a.view(b, A, 51)
              - a.view(b, A, 51).mean(1, keepdim=True))

    def library_head():
        qa = (torch.softmax(logits, dim=2) * z).sum(dim=2)
        return qa.argmax(dim=1)
    rows.append(dict(
        name="dueling_head", route="triton",
        source="rainbow_tpu_torch/kernels/dueling_head.py",
        replaces="rainbow_tpu/models/dqn.py:148",
        shape=f"B={b} A={A} atoms=51 no dist",
        ms=time_ms(torch, lambda: dueling_head_fwd(v, a, z, A, None)),
        plain_ms=time_ms(torch, lambda: dueling_head_plain(v, a, z, A, None)),
        library_ms=time_ms(torch, library_head),
        flops=b * A * 51 * 10,
        bytes=4 * (b * 51 + b * A * 51 + 51 + b * A + b) + 8 * b))

    # KC at the actor's step: the live stack's shape, this run's last reset
    # count, one replay column.
    obs, packed, ridx, rewards, dones, kinds = staged
    k = packed.shape[0]
    st = stack.clone()
    rep = rp.init_replay(b, 4, 84, "cuda")
    acts = torch.zeros(b, dtype=torch.int64, device="cuda")
    call = lambda fn: (lambda: fn(st, obs, packed, ridx, kinds, rep, acts,
                                  rewards, dones, 1.0))
    p = 84 * 84
    rows.append(dict(
        name="append_framestack", route="cuda",
        source="rainbow_tpu_torch/kernels/csrc/append_framestack.cu",
        replaces="rainbow_tpu/replay/prioritized.py:73",
        shape=f"N={b} H=4 K={k} resets",
        ms=time_ms(torch, call(append_framestack)),
        plain_ms=time_ms(torch, call(pp.append_framestack_plain)),
        library_ms=None,
        flops=0,
        bytes=(2 * b * p * 4 + b * p + k * p + 4 * k + b + b * p
               + b * (8 + 4 + 1) + b * (4 + 4 + 4 + 1 + 4) + 2 * b * 4)))

    for r in rows:
        r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                                  r["flops"] / FP32_FLOP_PER_S)
        r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                         >= r["flops"] / FP32_FLOP_PER_S else "operations")
        r["kernel_ms"] = r["ms"]
        r["launches"] = actor_counts[r["name"]]
        r["eval_launches"] = eval_counts[r["name"]]
        r["max_abs_err"] = errs[r["name"]]
    return rows


# ---------------------------------------------------------------- main -----

def main() -> int:
    args = parse_args()
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

    from rainbow_tpu_torch import canonical
    from rainbow_tpu_torch import evaluate as ev
    from rainbow_tpu_torch.envs import engine
    from rainbow_tpu_torch.kernels import build, launches, reset_launches
    from rainbow_tpu_torch.models.dqn import init_dqn_params
    from rainbow_tpu_torch.train import make_env_factory

    os.makedirs(OUT_DIR, exist_ok=True)
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
    log(f"[build] nvcc {nvcc_s:.1f} s (both sources in parallel), engine "
        f"ready after {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    smi_line = smi[0] if smi else ""
    log(smi_line)

    # 2. kernel vs plain -----------------------------------------------------
    # Full fp32 matrix products and convolutions for the whole run: the
    # comparisons then measure the kernels and not TF32 rounding (about
    # three decimal digits), and the timed phases compute at the precision
    # the configuration states (compute_dtype float32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = canonical(game=GAME, num_envs=ENVS, seed=SEED)
    probe = engine.BatchedEnv(GAME, 1, 0)
    A = probe.action_space
    probe.close()
    t0 = time.perf_counter()
    report = []
    errs = {"noisy_linear_fwd": compare_noisy_linear(torch, A, report)}
    t_triton = time.perf_counter()
    errs["dueling_head"] = compare_dueling_head(torch, A, report)
    errs["append_framestack"] = compare_append_framestack(torch, np, report)
    torch.cuda.synchronize()
    with open(os.path.join(OUT_DIR, "compare.json"), "w") as f:
        json.dump(report, f, indent=0)
    log(f"[compare] {len(report)} cases agree in "
        f"{time.perf_counter() - t0:.1f} s (dueling_head's Triton compile "
        f"included from {t_triton - t0:.1f} s); max |err| {errs}")

    # 3. actor ---------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_dqn_params(cfg, A, torch.Generator().manual_seed(SEED),
                             "cuda")
    stats, stack, rep, env, staged, actions = run_actor(torch, cfg, params,
                                                        A, gen)
    env.close()
    log("[actor] " + json.dumps(stats))
    q_err = check_actor_step_against_plain(torch, np, cfg, params, A, stack,
                                           staged, actions)
    log(f"[actor] one step on 32 envs matches the plain path on the CPU "
        f"(max |q diff| {q_err:.3g})")
    del rep
    torch.cuda.empty_cache()

    # 4. evaluate ------------------------------------------------------------
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
    check(all(v > 0 for v in eval_counts.values()),
          f"evaluate: a kernel never launched {eval_counts}")
    log("[evaluate] " + json.dumps({
        "episodes": 10, "max_episode_length": EVAL_FRAMES,
        "mean_reward": mean_r, "mean_q": mean_q,
        "validation_states_s": t1 - t0, "evaluate_s": eval_s,
        "eval_steps": eval_steps, "eval_steps_per_s": eval_steps / eval_s,
        "launches": eval_counts}))
    if args.profile:
        profile_actor(torch, cfg, params, A, gen)

    # 5. kernels line --------------------------------------------------------
    rows = kernel_rows(torch, np, A, errs, stats["launches"], eval_counts,
                       stack, staged)
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(smi_line)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
