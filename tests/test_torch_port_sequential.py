"""The port's sequential PER path (replay.sample, agent.compute_update,
agent.learn_step, train.learner_round's sequential round) against the JAX
package's, on the CPU through the kernels' plain versions.

JAX draws inside these functions: ``sample``'s uniforms from the sample
key, the online noise from ``agent.noise_key`` (shared over the batch) and
the target noise from a key split off ``agent.rng``. The test recomputes
those draws in JAX (``jax.random.uniform``, ``models.dqn.draw_noise`` on
the same keys) and injects them into the port.

Tolerances, as in test_torch_port_learner.py and for the same reasons:
indices and actions exact, float stacks to one float32 ulp; returns and IS weights to 1e-6
relative; losses and priorities (loss^ω) to 1e-5 (float32 in another
order); params after Adam to lr/100, and every tensor must have moved by
more than that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rainbow_tpu
from rainbow_tpu import agent as jag
from rainbow_tpu import train as jtrain
from rainbow_tpu.models import dqn as jdqn
from rainbow_tpu.replay import prioritized as jrp

import rainbow_tpu_torch
from rainbow_tpu_torch import agent as tag
from rainbow_tpu_torch import train as ttrain
from rainbow_tpu_torch.models import dqn as tdqn
from rainbow_tpu_torch.replay import prioritized as trp

from test_torch_port_learner import (A, BS, F32, KW, _agents,
                                     _assert_agent_close, _assert_same_replay,
                                     _batch, _eps_to_torch, _flat, _replay,
                                     _t)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: chains of small ops, which several test workers
    sharing the cores would otherwise slow by thread contention; the
    results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sequential_configs():
    return (rainbow_tpu.canonical(**KW, sequential_per=True),
            rainbow_tpu_torch.canonical(**KW, sequential_per=True))


def _learn_draws(jcfg, ja, key):
    """The draws JAX's learn_step makes for ``ja`` and sample key ``key``
    (agent.py:152-161, prioritized.py:124)."""
    _, k_target = jax.random.split(ja.rng)
    return {"u": _t(jax.random.uniform(key, (BS,), jnp.float32)),
            "online": _eps_to_torch(jdqn.draw_noise(jcfg, A, ja.noise_key)),
            "target": _eps_to_torch(jdqn.draw_noise(jcfg, A, k_target))}


@pytest.mark.parametrize("full", [True, False])
def test_sample_matches_jax(full):
    j, t = _replay(full=full, index=20)
    key = jax.random.key(12)
    want = jrp.sample(j, key, 0.6, batch_size=BS, history=4, n_step=3,
                      discount=0.99)
    u = _t(jax.random.uniform(key, (BS,), jnp.float32))
    got = trp.sample(t, 0.6, batch_size=BS, history=4, n_step=3,
                     discount=0.99, u=u)
    assert got.keys() == want.keys()
    for k in ("idxs", "actions", "nonterminals"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # The stacks are uint8 / 255 in float32; XLA multiplies by the
    # reciprocal of 255 instead, so they agree to one float32 ulp (6e-8).
    for k in ("states", "next_states"):
        assert got[k].dtype == torch.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=6e-8, err_msg=k)
    for k in ("returns", "weights", "weights_max"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    assert float(got["weights"].max()) == 1.0


def test_compute_update_matches_jax():
    jcfg, tcfg = _sequential_configs()
    ja, ta = _agents(jcfg, tcfg, seed=3)
    batch = _batch(np.random.default_rng(13))
    draws = _learn_draws(jcfg, ja, jax.random.key(0))
    grads, losses, _ = jax.jit(jag.compute_update,
                               static_argnames=("cfg", "action_space"))(
        ja, jcfg, A, {k: jnp.asarray(v) for k, v in batch.items()})
    tgrads, tlosses = tag.compute_update(
        ta, tcfg, A, {k: torch.from_numpy(v) for k, v in batch.items()},
        draws)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(losses), **F32)
    want = _flat(grads)
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        torch.testing.assert_close(tgrads[k], v, atol=1e-5 * scale,
                                   rtol=1e-4, msg=lambda m, k=k: f"{k}: {m}")
    # Without draws, the online and the target noise come from the agent's
    # stream: two shared draws.
    probe = dataclasses.replace(ta.noise)
    tag.compute_update(ta, tcfg, A,
                       {k: torch.from_numpy(v) for k, v in batch.items()})
    tdqn.draw_noise(tcfg, A, probe, device="cpu")
    tdqn.draw_noise(tcfg, A, probe, device="cpu")
    assert ta.noise == probe


def test_learn_step_matches_jax():
    jcfg, tcfg = _sequential_configs()
    ja, ta = _agents(jcfg, tcfg, seed=4)
    j, t = _replay(index=9)
    key = jax.random.key(14)
    draws = _learn_draws(jcfg, ja, key)
    j_before = np.asarray(j.priorities).copy()
    params0 = {k: v.clone() for k, v in ta.params.items()}
    ja, j2, jloss = jag.learn_step(ja, j, jcfg, A, jnp.float32(0.5), key)
    loss = tag.learn_step(ta, t, tcfg, A, 0.5, draws)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    _assert_agent_close(ta, ja, params0, 1)
    _assert_same_replay(t, j2)
    assert 0 < (t.priorities.numpy() != j_before).sum() <= BS
    assert ta.step == 1


def test_sequential_round_matches_jax_over_three_updates():
    """JAX's round (train.py:421-448): per update, reset_noise folds the
    noise key, then learn_step with the update's sample key; the target key
    comes off agent.rng, which each update advances."""
    jcfg, tcfg = _sequential_configs()
    ja, ta = _agents(jcfg, tcfg, seed=5)
    j, t = _replay(index=9)
    nl, beta, key = 3, 0.55, jax.random.key(22)
    noise_key, rng, per = ja.noise_key, ja.rng, []
    for k in jax.random.split(key, nl):
        noise_key = jax.random.fold_in(noise_key, 1)
        rng, k_target = jax.random.split(rng)
        per.append((jax.random.uniform(k, (BS,), jnp.float32),
                    jdqn.draw_noise(jcfg, A, noise_key),
                    jdqn.draw_noise(jcfg, A, k_target)))
    stack = lambda i: {n: tuple(_t(np.stack([np.asarray(p[i][n][h])
                                             for p in per]))
                                for h in (0, 1))
                       for n in per[0][i]}
    draws = {"u": _t(np.stack([np.asarray(p[0]) for p in per])),
             "online": stack(1), "target": stack(2)}
    j_before = np.asarray(j.priorities).copy()
    params0 = {k: v.clone() for k, v in ta.params.items()}
    ja, j2, jloss = jtrain.learner_round(ja, j, jcfg, A, nl, beta, key)
    loss = ttrain.learner_round(ta, t, tcfg, A, nl, beta, draws)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    _assert_agent_close(ta, ja, params0, nl)
    _assert_same_replay(t, j2)
    assert (t.priorities.numpy() != j_before).sum() > BS  # several updates
    assert ta.step == nl


def test_batched_round_learns_like_the_sequential_round():
    """After tests/test_replay.py:302: the same config and data through
    both rounds give finite losses in the same range, with priorities
    written back."""
    losses = {}
    for seq in (False, True):
        cfg = rainbow_tpu_torch.canonical(
            num_envs=4, memory_capacity=4 * 64, hidden_size=32, batch_size=8,
            sequential_per=seq)
        agent = tag.init_agent(cfg, 4, 0, "cpu")
        st = trp.init_replay(4, cfg.capacity_per_env, device="cpu")
        rng = np.random.default_rng(0)
        for s in range(40):
            trp.append(st, torch.full((4, 84, 84), (s + 1) % 256,
                                      dtype=torch.uint8),
                       torch.from_numpy(rng.integers(0, 4, 4)),
                       torch.from_numpy(rng.normal(size=4)
                                        .astype(np.float32)),
                       torch.full((4,), (s + 1) % 11 == 0))
        ls = [float(ttrain.learner_round(agent, st, cfg, 4, 4, 0.5))
              for _ in range(3)]
        assert np.all(np.isfinite(ls))
        assert float(st.max_priority) > 0 and agent.step == 12
        losses[seq] = ls
    assert abs(losses[False][-1] - losses[True][-1]) < 1.0
