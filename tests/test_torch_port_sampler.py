"""The plain versions of the replay's sampler and write-back kernels (K5
stratified_sample_plain, K6 gather_window_plain, K7 update_priorities_plain
in rainbow_tpu_torch/replay/prioritized.py) against the JAX package's
sample_many and update_priorities, on the CPU, at the edges the card
kernels must also meet: a leaf count that is not a power of two, the write
head at column 0 and at C-1 of a full ring, n-step 1 and 20, one batch and
more batches than rows, and an empty ring. The kernel wrappers refuse CPU
tensors, and the sampler launches nothing on a CPU ring.

JAX draws u inside its sampler; the test makes the same draw from the same
key and hands it to the port. Indices, frames, actions and nonterminals are
exact; returns and IS weights agree to 1e-6 relative (pow and a dot product
in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu.replay import prioritized as jrp

from rainbow_tpu_torch import kernels
from rainbow_tpu_torch.kernels import replay as k_replay
from rainbow_tpu_torch.replay import prioritized as trp

A = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these runs are chains of tiny ops, which several
    test workers sharing the cores would otherwise slow by thread
    contention; the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(e, c, index, full, seed=0, empty=False):
    """The same random ring in both packages: episode starts about every 6
    steps, random priorities with some zeros."""
    rng = np.random.default_rng(seed)
    ts = np.zeros((e, c), np.int32)
    for i in range(e):
        t = 0
        for j in range(c):
            ts[i, j] = t
            t = 0 if rng.random() < 0.17 else t + 1
    pr = rng.gamma(2.0, 1.0, (e, c)).astype(np.float32)
    pr[rng.random((e, c)) < 0.1] = 0.0
    if empty:
        pr[:] = 0.0
    fields = dict(
        frames=rng.integers(0, 256, (e, c, 84 * 84)).astype(np.uint8),
        actions=rng.integers(0, A, (e, c)).astype(np.int32),
        rewards=rng.normal(size=(e, c)).astype(np.float32),
        timesteps=ts, nonterminal=rng.random((e, c)) > 0.1, priorities=pr,
        index=np.int32(index), full=np.bool_(full),
        t=rng.integers(0, 9, e).astype(np.int32),
        max_priority=np.float32(max(pr.max(), 1.0)))
    j = jrp.init_replay(e, c).replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    t = trp.ReplayState(**{k: torch.from_numpy(np.array(v))
                           for k, v in fields.items()})
    return j, t


CASES = {
    # (E, C, index, full, n_step, num_batches, batch_size)
    "leaves_not_pow2": (3, 37, 20, True, 3, 3, 4),
    "head_at_0_full": (4, 32, 0, True, 3, 2, 8),
    "head_at_last_full": (4, 32, 31, True, 3, 2, 8),
    "head_partial": (4, 32, 17, False, 3, 2, 8),
    "n_step_1": (4, 32, 9, True, 1, 2, 4),
    "n_step_20": (2, 64, 40, True, 20, 2, 4),
    "one_batch": (4, 32, 9, True, 3, 1, 16),
    "batches_over_rows": (4, 32, 9, True, 3, 9, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampler_plain_versions_match_jax(case):
    e, c, index, full, n, nb, bs = CASES[case]
    j, t = _ring(e, c, index, full)
    key = jax.random.key(3)
    want = jrp.sample_many(j, key, 0.6, num_batches=nb, batch_size=bs,
                           history=4, n_step=n, discount=0.99,
                           states_uint8=True)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (nb * bs,),
                                                       jnp.float32)))
    kernels.reset_launches()
    got = trp.sample_many(t, 0.6, num_batches=nb, batch_size=bs, history=4,
                          n_step=n, discount=0.99, u=u)
    assert kernels.launches() == dict.fromkeys(kernels.LAUNCHES, 0)
    assert got.keys() == want.keys()
    for k in ("idxs", "states", "next_states", "actions", "nonterminals"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("returns", "weights", "weights_max"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    # The stacks are views of one (nb, bs, history + n, F·F) window.
    store = got["states"].untyped_storage()
    assert store.data_ptr() == got["next_states"].untyped_storage().data_ptr()
    assert store.nbytes() == nb * bs * (4 + n) * 84 * 84
    # K5's part alone: the draws in draw order, the leaf values, the total.
    idx, p, total = trp.stratified_sample_plain(t, u, 4, n)
    np.testing.assert_array_equal(idx.view(bs, nb).T.numpy(),
                                  got["idxs"].numpy())
    np.testing.assert_array_equal(p.numpy(),
                                  t.priorities.view(-1)[idx].numpy())
    assert bool((p > 0).all()) and float(total) > 0
    # Draws are nondecreasing in draw order (the write-back kernel relies
    # on it to pick the last of a run of one leaf).
    assert bool((idx[1:] >= idx[:-1]).all())


def test_sampling_an_empty_ring_matches_jax_with_zero_weights():
    j, t = _ring(4, 32, 9, True, empty=True)
    key = jax.random.key(4)
    want = jrp.sample_many(j, key, 0.4, num_batches=2, batch_size=4,
                           history=4, n_step=3, discount=0.99,
                           states_uint8=True)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (8,),
                                                       jnp.float32)))
    got = trp.sample_many(t, 0.4, num_batches=2, batch_size=4, history=4,
                          n_step=3, discount=0.99, u=u)
    assert torch.equal(got["weights"], torch.zeros(2, 4))
    np.testing.assert_array_equal(got["idxs"].numpy(),
                                  np.asarray(want["idxs"]))
    np.testing.assert_array_equal(got["weights_max"].numpy(),
                                  np.asarray(want["weights_max"]))


def test_write_back_plain_matches_jax_in_batch_order():
    """update_priorities takes the round's (nb, bs) indices and losses as
    sample_many and the round give them."""
    j, t = _ring(4, 32, 9, True)
    rng = np.random.default_rng(5)
    idxs = rng.choice(4 * 32, size=(3, 4), replace=False).astype(np.int64)
    losses = rng.uniform(0.01, 9.0, (3, 4)).astype(np.float32)
    j2 = jrp.update_priorities(j, jnp.asarray(idxs.reshape(-1)),
                               jnp.asarray(losses.reshape(-1)), 0.5)
    kernels.reset_launches()
    out = trp.update_priorities(t, torch.from_numpy(idxs),
                                torch.from_numpy(losses), 0.5)
    assert out is t and kernels.launches()["write_priorities"] == 0
    np.testing.assert_array_equal(t.priorities.numpy(),
                                  np.asarray(j2.priorities))
    assert float(t.max_priority) == float(j2.max_priority)


@pytest.mark.parametrize("nan_at", [0, 5, 11])
def test_write_back_plain_propagates_a_nan_loss_as_jax_does(nan_at):
    """A NaN loss makes max_priority NaN in JAX (jnp.maximum) and in the
    plain version (torch.maximum), and its leaf's priority NaN; a -0.0 loss
    writes a zero that compares equal to JAX's (JAX's pow gives +0.0, the
    port's torch.pow -0.0). The other leaves are exact."""
    j, t = _ring(4, 32, 9, True)
    rng = np.random.default_rng(nan_at)
    idxs = rng.choice(4 * 32, size=(3, 4), replace=False).astype(np.int64)
    losses = rng.uniform(0.01, 9.0, (3, 4)).astype(np.float32)
    losses.reshape(-1)[nan_at] = np.nan
    losses.reshape(-1)[(nan_at + 1) % 12] = -0.0
    j2 = jrp.update_priorities(j, jnp.asarray(idxs.reshape(-1)),
                               jnp.asarray(losses.reshape(-1)), 0.5)
    trp.update_priorities(t, torch.from_numpy(idxs), torch.from_numpy(losses),
                          0.5)
    assert np.isnan(float(j2.max_priority))
    assert np.isnan(float(t.max_priority))
    np.testing.assert_array_equal(t.priorities.numpy(),
                                  np.asarray(j2.priorities))  # NaN == NaN
    assert np.isnan(t.priorities.view(-1)[idxs.reshape(-1)[nan_at]].item())


@pytest.mark.parametrize("call", [
    lambda t: k_replay.stratified_sample(t, torch.rand(4), 4, 3),
    lambda t: k_replay.gather_window(
        t, torch.zeros(4, dtype=torch.int64), torch.ones(4),
        torch.ones(()), 0.4, 2, 2, 4, 3, 0.99),
    lambda t: k_replay.write_priorities(
        t, torch.zeros(4, dtype=torch.int64), torch.ones(4), 0.5),
])
def test_replay_kernel_wrappers_refuse_cpu_tensors(call):
    _, t = _ring(2, 16, 3, True)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        call(t)
    assert kernels.launches() == dict.fromkeys(kernels.LAUNCHES, 0)
