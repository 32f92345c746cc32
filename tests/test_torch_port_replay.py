"""The port's replay ring (rainbow_tpu_torch.replay.prioritized) against the
JAX package, on the CPU, bit-exact: init, append across a wrap of the ring,
stored_count and all_states with episode-start blanking."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu.replay import prioritized as jrp

from rainbow_tpu_torch.replay import prioritized as trp

E, C = 3, 4


def assert_same(j, t):
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), np.asarray(getattr(j, f.name))
        assert got.shape == want.shape, f.name
        assert got.numpy().dtype == want.dtype, f.name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)


def test_init_replay_matches_jax():
    assert_same(jrp.init_replay(E, C), trp.init_replay(E, C, device="cpu"))


def _run(steps, seed=0, max_priority=None):
    """Append ``steps`` random transitions to both rings; compare after each."""
    rng = np.random.default_rng(seed)
    j = jrp.init_replay(E, C)
    t = trp.init_replay(E, C, device="cpu")
    if max_priority is not None:
        j = j.replace(max_priority=jnp.float32(max_priority))
        t.max_priority.fill_(max_priority)
    for _ in range(steps):
        frames = rng.integers(0, 256, (E, 84, 84), np.uint8)
        acts = rng.integers(0, 6, E)
        rewards = rng.normal(size=E).astype(np.float32)
        terms = rng.random(E) < 0.3
        j = jrp.append(j, jnp.asarray(frames), jnp.asarray(acts),
                       jnp.asarray(rewards), jnp.asarray(terms))
        out = trp.append(t, torch.from_numpy(frames), torch.from_numpy(acts),
                         torch.from_numpy(rewards), torch.from_numpy(terms))
        assert out is t  # in place
        assert_same(j, t)
    return j, t


def test_append_across_a_wrap():
    j, t = _run(C + 3)
    assert bool(t.full) and int(t.index) == 3
    # An env's t restarts at 0 after a terminal and counts up otherwise.
    assert t.t.dtype == torch.int32 and t.index.dim() == 0


def test_append_fills_at_max_priority():
    j, t = _run(2, seed=1, max_priority=2.5)
    np.testing.assert_array_equal(t.priorities[:, :2].numpy(), 2.5)
    np.testing.assert_array_equal(t.priorities[:, 2:].numpy(), 0.0)


@pytest.mark.parametrize("steps", [0, 2, C, C + 1])
def test_stored_count_matches_jax(steps):
    j, t = _run(steps, seed=2)
    got = trp.stored_count(t)
    assert got.dim() == 0  # a device tensor: no host sync
    assert int(got) == int(jrp.stored_count(j))


@pytest.mark.parametrize("history", [4, 2])
def test_all_states_blanks_episode_starts_like_jax(history):
    j, t = _run(C + 2, seed=3)
    # Force episode starts inside the windows so the blanking matters.
    ts = np.asarray(j.timesteps).copy()
    ts[0, 1] = 0
    ts[2, 3] = 0
    j = j.replace(timesteps=jnp.asarray(ts))
    t.timesteps.copy_(torch.from_numpy(ts))
    want = np.asarray(jrp.all_states(j, history))
    got = trp.all_states(t, history)
    assert got.shape == (E * C, 84, 84, history) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any()  # some frames were blanked
