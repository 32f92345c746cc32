"""The port's frame stack and its fused append + frame-stack step
(rainbow_tpu_torch.ops.preprocess) against the JAX package, on the CPU,
where they run as the plain version of the append + frame-stack kernel.
All comparisons are bit-exact: the work is integer and the only float, a
clipped reward, is copied, not computed differently."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rainbow_tpu
from rainbow_tpu.ops import preprocess as jpp
from rainbow_tpu.replay import prioritized as jrp
from rainbow_tpu.train import update_step_packed

from rainbow_tpu_torch.ops import preprocess as tpp
from rainbow_tpu_torch.replay import prioritized as trp
from rainbow_tpu_torch.train import pack_resets

N = 6


def _frames(rng, *shape):
    return rng.integers(0, 256, shape, np.uint8)


def _kinds(rng, kind):
    if kind == "mixed":
        return np.array([0, 1, 2, 0, 2, 1], np.uint8)
    return np.full(N, kind, np.uint8)


@pytest.mark.parametrize("kind", [0, 1, 2, "mixed"])
def test_update_framestack_matches_jax(kind):
    rng = np.random.default_rng(kind if kind != "mixed" else 9)
    stack, obs, resets = (_frames(rng, N, 84, 84, 4), _frames(rng, N, 84, 84),
                          _frames(rng, N, 84, 84))
    kinds = _kinds(rng, kind)
    want = jpp.update_framestack(*map(jnp.asarray, (stack, obs, resets,
                                                     kinds)))
    st = torch.from_numpy(stack)
    got = tpp.update_framestack(st, torch.from_numpy(obs),
                                torch.from_numpy(resets),
                                torch.from_numpy(kinds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(st.numpy(), stack)  # input left unchanged


def test_init_framestack_and_network_input_match_jax():
    rng = np.random.default_rng(1)
    first = _frames(rng, N, 84, 84)
    want = jpp.init_framestack(N, 4, jnp.asarray(first))
    got = tpp.init_framestack(N, 4, first, device="cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = _frames(rng, N, 84, 84, 4)
    np.testing.assert_array_equal(
        tpp.to_network_input(torch.from_numpy(x)).numpy(),
        np.asarray(jpp.to_network_input(jnp.asarray(x))))


def _replays(n, c):
    return jrp.init_replay(n, c), trp.init_replay(n, c, device="cpu")


def assert_same_replay(j, t):
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(
            getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name)),
            err_msg=f.name)


@pytest.mark.parametrize("reward_clip", [1.0, 0.0])
def test_append_framestack_matches_update_core(reward_clip):
    """The fused step against _update_core with packed resets
    (train.py:63-72, 143-150): padded reset rows dropped, rewards clipped,
    the ring wrapping over five steps of a three-column ring."""
    cfg = rainbow_tpu.data_efficient(hidden_size=32, reward_clip=reward_clip)
    rng = np.random.default_rng(2)
    c = 3
    jrep, trep = _replays(N, c)
    first = _frames(rng, N, 84, 84)
    jstack = jpp.init_framestack(N, 4, jnp.asarray(first))
    tstack = tpp.init_framestack(N, 4, first, device="cpu")
    for step in range(5):
        obs, resets = _frames(rng, N, 84, 84), _frames(rng, N, 84, 84)
        kinds = rng.integers(0, 3, N).astype(np.uint8)
        kinds[step % N] = 0
        packed, ridx = pack_resets(resets, kinds)
        assert (ridx == N).any() or len(ridx) == N  # padding is exercised
        acts = rng.integers(0, 4, N)
        rewards = (rng.normal(size=N) * 3).astype(np.float32)
        dones = kinds > 0
        jstack, jrep = update_step_packed(
            cfg, 4, jstack, jrep, jnp.asarray(acts), jnp.asarray(obs),
            jnp.asarray(packed), jnp.asarray(ridx), jnp.asarray(rewards),
            jnp.asarray(dones), jnp.asarray(kinds))
        tpp.append_framestack(
            tstack, torch.from_numpy(obs), torch.from_numpy(packed),
            torch.from_numpy(ridx), torch.from_numpy(kinds), trep,
            torch.from_numpy(acts), torch.from_numpy(rewards),
            torch.from_numpy(dones), cfg.reward_clip)
        np.testing.assert_array_equal(tstack.numpy(), np.asarray(jstack))
        assert_same_replay(jrep, trep)
    assert bool(trep.full) and int(trep.index) == 5 % c


def test_append_framestack_stack_only_mode():
    """Without a replay only the stack advances, as the evaluator steps."""
    rng = np.random.default_rng(3)
    stack = _frames(rng, N, 84, 84, 4)
    obs, resets = _frames(rng, N, 84, 84), _frames(rng, N, 84, 84)
    kinds = _kinds(rng, "mixed")
    packed, ridx = pack_resets(resets, kinds)
    dense = np.zeros_like(resets)
    dense[kinds > 0] = resets[kinds > 0]
    want = jpp.update_framestack(*map(jnp.asarray, (stack, obs, dense, kinds)))
    st = torch.from_numpy(stack.copy())
    tpp.append_framestack(st, torch.from_numpy(obs), torch.from_numpy(packed),
                          torch.from_numpy(ridx), torch.from_numpy(kinds))
    np.testing.assert_array_equal(st.numpy(), np.asarray(want))


def test_pack_resets_matches_jax():
    from rainbow_tpu.train import pack_resets as jpack
    rng = np.random.default_rng(4)
    resets = _frames(rng, 40, 84, 84)
    for n_reset in (0, 1, 9, 40):
        kinds = np.zeros(40, np.uint8)
        kinds[rng.choice(40, n_reset, replace=False)] = 1
        for a, b in zip(pack_resets(resets, kinds), jpack(resets, kinds)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
