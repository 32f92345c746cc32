"""The port's delta uploads (train._apply_delta_plain, K10's plain version;
actor_step_delta; the Trainer with cfg.delta_uploads) on the CPU: against
the JAX package's _apply_delta, against the dense path on the native
engine, and through the Trainer. Everything here is integer work or the
same float ops on the same inputs, so every comparison is exact.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu.train import _apply_delta as jax_apply_delta
from rainbow_tpu.train import pack_delta as jax_pack_delta

import rainbow_tpu_torch
from rainbow_tpu_torch import agent as tag
from rainbow_tpu_torch.envs.engine import BatchedEnv
from rainbow_tpu_torch.models.dqn import draw_noise
from rainbow_tpu_torch.models.noisy import NoiseStream
from rainbow_tpu_torch.ops.preprocess import init_framestack
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch.train import (Trainer, _apply_delta_plain,
                                     actor_step_delta, actor_step_packed,
                                     delta_offsets, pack_delta, pack_resets)

F = 84


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: chains of small ops, which several test workers
    sharing the cores would otherwise slow by thread contention; the
    results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_delta(rng, n, h, empty_env=1):
    """A stack and a sorted, per-env unique delta against its newest plane
    (one env unchanged: a count may be 0)."""
    stack = rng.integers(0, 256, (n, F, F, h), np.uint8)
    counts = np.array([0 if e == empty_env else rng.integers(1, 60)
                       for e in range(n)], np.int32)
    pos = np.concatenate([np.sort(rng.choice(F * F, c, replace=False))
                          for c in counts]).astype(np.uint16)
    val = rng.integers(0, 256, pos.shape[0]).astype(np.uint8)
    return stack, counts, pos, val


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("h", [4, 3])
def test_apply_delta_matches_jax(padded, h):
    """After tests/test_delta.py:146: pad entries past the counts' sum are
    dropped, with or without a bucket's padding."""
    stack, counts, pos, val = _random_delta(np.random.default_rng(h), 5, h)
    if padded:
        ppos, pval = pack_delta(pos, val)
        jpos, jval = jax_pack_delta(pos, val)
        np.testing.assert_array_equal(ppos, jpos)
        np.testing.assert_array_equal(pval, jval)
        assert ppos.shape[0] > pos.shape[0]
    else:
        ppos, pval = pos, val
    want = np.asarray(jax_apply_delta(jnp.asarray(stack), jnp.asarray(counts),
                                      jnp.asarray(ppos), jnp.asarray(pval)))
    got = _apply_delta_plain(torch.from_numpy(stack),
                             torch.from_numpy(delta_offsets(counts)),
                             torch.from_numpy(ppos), torch.from_numpy(pval))
    assert got.dtype == torch.uint8 and got.shape == (5, F, F)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("n", [1, 9, 1024])
def test_apply_delta_offsets_match_jax_counts(n, padded):
    """The port takes a delta's exclusive offsets, built on the host
    (delta_offsets), where JAX takes the counts: the same observations at
    one env, nine and the canonical 1024, each with an unchanged env (but
    at N = 1) and an env whose whole plane changed, padded to a bucket or
    not."""
    rng = np.random.default_rng(n)
    stack, counts, pos, val = _random_delta(rng, n, 4,
                                            empty_env=1 if n > 1 else -1)
    whole = n // 2
    counts[whole] = F * F
    pos = np.concatenate([
        np.arange(F * F) if e == whole
        else np.sort(rng.choice(F * F, c, replace=False))
        for e, c in enumerate(counts)]).astype(np.uint16)
    val = rng.integers(0, 256, pos.shape[0]).astype(np.uint8)
    offsets = delta_offsets(counts)
    assert offsets.dtype == np.int32 and offsets.shape == (n + 1,)
    np.testing.assert_array_equal(offsets, np.cumsum([0, *counts]))
    if padded:
        pos, val = pack_delta(pos, val)
    want = np.asarray(jax_apply_delta(jnp.asarray(stack), jnp.asarray(counts),
                                      jnp.asarray(pos), jnp.asarray(val)))
    got = _apply_delta_plain(torch.from_numpy(stack),
                             torch.from_numpy(offsets),
                             torch.from_numpy(pos), torch.from_numpy(val))
    np.testing.assert_array_equal(got.numpy(), want)


def test_actor_step_delta_equals_dense_on_the_native_engine():
    """After tests/test_delta.py:167, on two native pong engines with one
    seed: each step the dense engine's observations go through
    actor_step_packed, the delta engine's step_delta through
    actor_step_delta (or, on its dense fallback, actor_step_packed); the
    actions, stacks and replays stay equal, with the same injected noise."""
    n = 4
    cfg = rainbow_tpu_torch.data_efficient(num_envs=n, hidden_size=32,
                                           memory_capacity=n * 32)
    dense_env, delta_env = BatchedEnv("pong", n, 3), BatchedEnv("pong", n, 3)
    a_space = dense_env.action_space
    agent = tag.init_agent(cfg, a_space, 0, "cpu")
    first = dense_env.reset_all()
    np.testing.assert_array_equal(first, delta_env.reset_all())
    runs = {k: (init_framestack(n, 4, first, "cpu"),
                rp.init_replay(n, cfg.capacity_per_env, device="cpu"))
            for k in ("dense", "delta")}
    acts = torch.zeros(n, dtype=torch.int64)
    noise = NoiseStream(7)
    forms = []
    for _ in range(24):
        eps = draw_noise(cfg, a_space, noise, (n,), "cpu")
        acts_np = acts.numpy()
        obs, resets, rewards, dones, kinds = dense_env.step(acts_np)
        counts, dpos, dval, resets_d, rewards_d, dones_d, kinds_d = \
            delta_env.step_delta(acts_np)
        np.testing.assert_array_equal(kinds, kinds_d)
        packed, ridx = (torch.from_numpy(x) for x in pack_resets(resets,
                                                                 kinds))
        tail = (torch.from_numpy(rewards.astype(np.float32)),
                torch.from_numpy(dones.astype(bool)), torch.from_numpy(kinds))
        stack, rep = runs["dense"]
        want = actor_step_packed(agent.params, None, cfg, a_space, stack,
                                 rep, acts, torch.from_numpy(obs), packed,
                                 ridx, *tail, noise_eps=eps)
        stack, rep = runs["delta"]
        if counts is None:  # the engine's dense fallback
            got = actor_step_packed(agent.params, None, cfg, a_space, stack,
                                    rep, acts, torch.from_numpy(dpos),
                                    packed, ridx, *tail, noise_eps=eps)
        else:
            got = actor_step_delta(
                agent.params, None, cfg, a_space, stack, rep, acts,
                torch.from_numpy(delta_offsets(counts)),
                torch.from_numpy(dpos.copy()),
                torch.from_numpy(dval.copy()), packed, ridx, *tail,
                noise_eps=eps)
        forms.append(counts is not None)
        assert torch.equal(got, want)
        assert torch.equal(runs["delta"][0], runs["dense"][0])
        for f in dataclasses.fields(rep):
            assert torch.equal(getattr(runs["delta"][1], f.name),
                               getattr(runs["dense"][1], f.name)), f.name
        acts = want
    assert any(forms)
    dense_env.close()
    delta_env.close()


def test_trainer_with_delta_uploads_equals_dense_uploads(tmp_path):
    """After tests/test_delta.py:233: a short native-engine run with delta
    uploads completes, its iterations go through the delta form, and, the
    upload being lossless, it ends in the same state as the dense run."""
    kw = dict(game="pong", num_envs=4, memory_capacity=4 * 64, batch_size=8,
              total_steps=120, learn_start=40, replay_frequency=4,
              target_update=64, evaluation_interval=10 ** 9,
              evaluation_size=8, hidden_size=32, multi_step=3,
              results_dir=str(tmp_path), max_episode_length=1000)
    trs = {}
    for delta in (True, False):
        cfg = rainbow_tpu_torch.data_efficient(
            **kw, run_id=f"delta_{delta}", delta_uploads=delta)
        tr = Trainer(cfg, device="cpu")
        tr.run()
        assert tr.T >= cfg.total_steps
        assert np.isfinite(float(tr._last_loss))
        trs[delta] = tr
    assert trs[True].upload_forms["delta"] > 0
    assert trs[False].upload_forms == {"delta": 0, "dense": 30}
    assert sum(trs[True].upload_forms.values()) == 30
    a, b = trs[True], trs[False]
    for f in dataclasses.fields(a.rep):
        assert torch.equal(getattr(a.rep, f.name), getattr(b.rep, f.name))
    for k, v in a.agent.params.items():
        assert torch.equal(v, b.agent.params[k]), k
    assert a.agent.noise == b.agent.noise
