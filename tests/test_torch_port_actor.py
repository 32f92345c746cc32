"""The port's acting path as a whole (rainbow_tpu_torch.train, agent,
evaluate) against the JAX package, on the CPU, on the scripted fake env.

The actor runs 20 iterations of actor_step_packed side by side with
rainbow_tpu.train.actor_step_packed. JAX draws each iteration's per-env
noise inside jit from a key; models.dqn.draw_noise(key, lead=(N,)) makes
exactly those draws, and the port gets them as noise_eps. Stack and replay
must agree bit for bit each step; actions must agree wherever the top-2 gap
of the port's expected Q exceeds 1e-4 (float32 sums in other orders differ
by about 1e-6). The JAX actions drive both envs, so a near-tie cannot make
the runs diverge.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import rainbow_tpu
from rainbow_tpu import agent as jag
from rainbow_tpu import evaluate as jev
from rainbow_tpu.envs.fake import FakeAtariEnv as JaxFake
from rainbow_tpu.models import dqn as jdqn
from rainbow_tpu.ops import preprocess as jpp
from rainbow_tpu.replay import prioritized as jrp
from rainbow_tpu.train import actor_step_packed as jax_actor_step_packed
from rainbow_tpu.train import pack_resets as jax_pack_resets

import rainbow_tpu_torch
from rainbow_tpu_torch import evaluate as tev
from rainbow_tpu_torch.convert import params_from_jax
from rainbow_tpu_torch.envs.fake import FakeAtariEnv as TorchFake
from rainbow_tpu_torch.models.dqn import forward_head
from rainbow_tpu_torch.ops import preprocess as tpp
from rainbow_tpu_torch.replay import prioritized as trp
from rainbow_tpu_torch.train import actor_step_packed, stage_step

N, A, C = 4, 4, 16
KW = dict(num_envs=N, memory_capacity=N * C, hidden_size=32,
          env_backend="fake", life_every=3)


def _configs(**kw):
    return (rainbow_tpu.data_efficient(**KW, **kw),
            rainbow_tpu_torch.data_efficient(**KW, **kw))


def _params(cfg, seed=0):
    jp = jdqn.init_dqn_params(jax.random.key(seed), cfg, A)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _assert_same_replay(j, t):
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                      np.asarray(getattr(j, f.name)),
                                      err_msg=f.name)


def test_actor_step_packed_matches_jax_for_20_iterations():
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg)
    envs = [Fake(N, seed=0, episode_len=7, life_every=3, training=True)
            for Fake in (JaxFake, TorchFake)]
    first = [e.reset_all() for e in envs]
    np.testing.assert_array_equal(*first)
    jstack = jpp.init_framestack(N, 4, jnp.asarray(first[0]))
    jrep = jrp.init_replay(N, C)
    tstack = tpp.init_framestack(N, 4, first[1], device="cpu")
    trep = trp.init_replay(N, C, device="cpu")
    key = jax.random.key(11)
    actions = jag.act(jp, jcfg, A, jpp.to_network_input(jstack), key)
    kinds_seen = set()
    for i in range(20):
        acts = np.array(actions)
        outs = [e.step(acts) for e in envs]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
        obs, resets, rewards, dones, kinds = outs[0]
        kinds_seen |= set(kinds.tolist())
        packed, ridx = jax_pack_resets(resets, kinds)
        k = jax.random.fold_in(key, i)
        actions, jstack, jrep = jax_actor_step_packed(
            jp, k, jcfg, A, jstack, jrep, jnp.asarray(acts), jnp.asarray(obs),
            jnp.asarray(packed), jnp.asarray(ridx), jnp.asarray(rewards),
            jnp.asarray(dones.astype(bool)), jnp.asarray(kinds))
        noise = {name: (torch.from_numpy(np.array(a)),
                        torch.from_numpy(np.array(b)))
                 for name, (a, b) in
                 jdqn.draw_noise(jcfg, A, k, lead=(N,)).items()}
        got = actor_step_packed(tp, None, tcfg, A, tstack, trep,
                                torch.from_numpy(acts), *stage_step(outs[1],
                                                                    "cpu"),
                                noise_eps=noise)
        np.testing.assert_array_equal(tstack.numpy(), np.asarray(jstack))
        _assert_same_replay(jrep, trep)
        q = forward_head(tp, tcfg, A, tpp.to_network_input(tstack),
                         noise_eps=noise).q
        top2 = q.topk(2, dim=1).values
        clear = (top2[:, 0] - top2[:, 1] > 1e-4).numpy()
        np.testing.assert_array_equal(got.numpy()[clear],
                                      np.asarray(actions)[clear])
    assert kinds_seen == {0, 1, 2}  # life losses and episode ends both ran
    assert bool(trep.full)          # and the ring wrapped


def _eval_env(Fake):
    def make(num_envs, training=True, seed_offset=0):
        return Fake(num_envs, seed=7 + seed_offset, episode_len=20,
                    training=training)
    return make


def test_run_episodes_and_validation_q_match_jax():
    jcfg, tcfg = _configs(eval_epsilon=0.0, max_episode_length=200,
                          evaluation_size=25)
    jp, tp = _params(jcfg, seed=1)
    want = jev.run_episodes(jcfg, jp, A, _eval_env(JaxFake),
                            jax.random.key(2), 3)
    got = tev.run_episodes(tcfg, tp, A, _eval_env(TorchFake),
                           torch.Generator().manual_seed(2), 3)
    assert got == want
    jvs = jev.build_validation_states(jcfg, _eval_env(JaxFake))
    tvs = tev.build_validation_states(tcfg, _eval_env(TorchFake), "cpu")
    np.testing.assert_array_equal(tvs.numpy(), np.asarray(jvs))
    np.testing.assert_allclose(
        tev.validation_q(tcfg, tp, A, tvs, chunk=10),
        jev.validation_q(jcfg, jp, A, jvs, chunk=10), atol=1e-5, rtol=1e-5)
    jm = jev.evaluate(jcfg, jp, A, _eval_env(JaxFake), jvs, jax.random.key(3))
    tm = tev.evaluate(tcfg, tp, A, _eval_env(TorchFake), tvs,
                      torch.Generator().manual_seed(3))
    assert tm[0] == jm[0]
    np.testing.assert_allclose(tm[1], jm[1], atol=1e-5, rtol=1e-5)
