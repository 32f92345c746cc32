"""The port's learner (rainbow_tpu_torch ops.c51, models.noisy backward,
agent's update and Adam, replay sampler and write-back, train's learner
round and fused iteration) against the JAX package, on the CPU, through the
kernels' plain versions.

Inputs are made with numpy from a seed. Where JAX draws inside
(``_stratified_find``'s u, a forward's per-layer noise, ``draw_noise``), the
test makes those draws in JAX from the same key and hands them to the port.

Tolerances, each with its reason:

- float32 arithmetic in another order (matmul, conv, einsum, sums): 1e-5
  absolute and relative on values of order 1, and 1e-4 relative on
  gradients, which are sums of hundreds of such products.
- bfloat16: the two frameworks round at slightly different points, so
  values of order 1 agree to a few bf16 ulps (2^-8 relative): 3e-2.
- Adam over 3 steps: the same float32 ops, but the global norm is summed in
  another order (a few float32 ulps), so params agree to 1e-7 absolute (two
  float32 ulps of the 0.1-scale params), nu to 1e-5 relative, mu (which
  crosses zero) to 1e-6 of its tensor's largest value, a bfloat16 mu to one
  bf16 ulp of that value (a rounding that falls the other way carries into
  later steps), and then params to 3·lr·2^-7 (a bf16 ulp of mu moves an
  update by up to 2^-7 of lr).
- Integer and uint8 results (sampled indices, stacks, actions) are exact;
  returns and IS weights agree to 1e-6 relative (pow and a dot product in
  another order).
- After a learner round, params agree to lr/100: the gradients differ from
  JAX's by float32 rounding Δg only, which moves an Adam step by at most
  lr·Δg/eps. Every tensor must also have moved by more than that, so a
  round whose updates never reached the params cannot pass.
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
from rainbow_tpu.models import noisy as jnoisy
from rainbow_tpu.ops import c51 as jc51
from rainbow_tpu.replay import prioritized as jrp

import rainbow_tpu_torch
from rainbow_tpu_torch import agent as tag
from rainbow_tpu_torch import train as ttrain
from rainbow_tpu_torch.convert import opt_state_from_jax, params_from_jax
from rainbow_tpu_torch.models import noisy as tnoisy
from rainbow_tpu_torch.models.dqn import forward_head
from rainbow_tpu_torch.ops import c51 as tc51
from rainbow_tpu_torch.ops.preprocess import to_network_input
from rainbow_tpu_torch.replay import prioritized as trp
from rainbow_tpu_torch.train import pack_resets

A, E, C, BS = 3, 4, 32, 4
KW = dict(num_envs=E, memory_capacity=E * C, hidden_size=32, batch_size=BS)
F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _n(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _configs(**kw):
    return rainbow_tpu.canonical(**KW, **kw), rainbow_tpu_torch.canonical(
        **KW, **kw)


# The configurations a learner round is held to JAX's in, at narrow widths:
# (preset, overrides, updates a round, ring columns, the params' update
# bound (None: each param to lr/100), q's top-2 gap that makes an action
# clear). The data-efficient preset
# brings its 5x5 stride-5 torso, n = 20 and replay frequency 1 (one update
# per env step), the throughput preset batch 256 and lr 6.25e-5·√8; the
# canonical one also runs with bfloat16 compute and a bfloat16 Adam first
# moment. The rings are wide enough that a round's stratified draws never
# repeat a leaf (n = 20 masks 24 columns around the write head; batch 256
# needs thousands of leaves).
#
# Params: in float32 each agrees with JAX's to lr/100 (the module
# docstring). In bfloat16 the two frameworks round the streams
# and the gradients at other points, and Adam's first steps g/(|g| + eps)
# turn a gradient near zero (a sum of many bf16 products that cancel) into
# a step of up to lr either way: bf16 itself moves JAX's own round's
# update away from its float32 update by up to 19 % in norm (a conv bias;
# 10-12 % on the conv weights, 1-4 % on the noisy layers). So each tensor's
# update p - p0 is held to JAX's in norm, as a share of its norm, with a
# bound for each kind of tensor (BF16_UPDATE) from its own readings here
# (the largest over both round tests): the convolutions' up to 0.21, the
# noisy layers' weights up to 0.027, their biases (few elements, so a few
# steps of ±lr weigh more) up to 0.17; a KA backward that drops one input
# chunk moves the noisy weights' update by 0.2 or more
# (test_bf16_round_check_refuses_a_dropped_chunk). q agrees to BF16, so an
# action is clear only where q's top-2 gap exceeds BF16's atol.
BF16_UPDATE = {"convs": 0.3, "weight": 0.06, "bias": 0.25}
ROUND_CASES = {
    "canonical": ("canonical", {}, 2, C, None, 1e-4),
    "data_efficient": ("data_efficient", {}, E, 64, None, 1e-4),
    "throughput": ("throughput", {"batch_size": 256}, 1, 1024, None, 1e-4),
    "bfloat16": ("canonical", {"compute_dtype": "bfloat16",
                               "adam_mu_dtype": "bfloat16"}, 2, C,
                 BF16_UPDATE, BF16["atol"]),
}


def _round_case(name):
    """(JAX config, port config, updates a round, ring columns, the params'
    update bound, q's clear gap) of ROUND_CASES[name]."""
    preset, kw, nl, c, update_rel, gap = ROUND_CASES[name]
    kw = dict(KW, memory_capacity=E * c, **kw)
    return (getattr(rainbow_tpu, preset)(**kw),
            getattr(rainbow_tpu_torch, preset)(**kw), nl, c, update_rel, gap)


def _eps_to_torch(eps):
    return {k: (_t(a), _t(b)) for k, (a, b) in eps.items()}


def _flat(tree):
    """A params-shaped JAX tree in the port's flat layout, on the CPU."""
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def _assert_dicts_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k].float(), want[k].float(), **tol,
                                   msg=lambda m, k=k: f"{k}: {m}")


# ----------------------------------------------------------------- C51 -----

def _projection_inputs(case):
    rng = np.random.default_rng(0)
    if case == "integer_b":
        # b lands exactly on atoms, both ends included (tests/test_c51.py:53).
        p = np.zeros((3, 51), np.float32)
        p[:, 25] = 1.0
        return (p, np.array([-10.0, 0.0, 10.0], np.float32),
                np.zeros(3, np.float32))
    p = rng.random((8, 51)).astype(np.float32)
    p /= p.sum(1, keepdims=True)
    return (p, rng.uniform(-12, 12, 8).astype(np.float32),
            (rng.random(8) > 0.3).astype(np.float32))


@pytest.mark.parametrize("case", ["random", "integer_b"])
def test_project_distribution_and_loss_match_jax(case):
    p, ret, nt = _projection_inputs(case)
    z = jc51.support_vector(-10.0, 10.0, 51)
    want = jc51.project_distribution(jnp.asarray(p), jnp.asarray(ret),
                                     jnp.asarray(nt), 0.99 ** 3, z, -10.0,
                                     10.0)
    got = tc51.project_distribution(_t(p), _t(ret), _t(nt), 0.99 ** 3,
                                    tc51.support_vector(-10, 10, 51, "cpu"),
                                    -10.0, 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-5)
    log_p = np.log(np.random.default_rng(1).dirichlet(np.ones(51), len(p)))
    log_p = log_p.astype(np.float32)
    np.testing.assert_allclose(
        tc51.c51_loss(_t(log_p), got).numpy(),
        np.asarray(jc51.c51_loss(jnp.asarray(log_p), want)), **F32)


def test_c51_target_gathers_at_a_star_then_projects():
    rng = np.random.default_rng(2)
    b = 6
    pns = rng.dirichlet(np.ones(51), (b, A)).astype(np.float32)
    a_star = rng.integers(0, A, b)
    ret = rng.uniform(-3, 3, b).astype(np.float32)
    ret[0] = 0.0  # with nonterminal 0: b exactly on the middle atom
    nt = np.array([0, 1, 1, 0, 1, 1], np.float32)
    z = jc51.support_vector(-10.0, 10.0, 51)
    pns_a = jnp.take_along_axis(jnp.asarray(pns),
                                jnp.asarray(a_star)[:, None, None], 1)[:, 0]
    want = jc51.project_distribution(pns_a, jnp.asarray(ret), jnp.asarray(nt),
                                     0.99 ** 3, z, -10.0, 10.0)
    got = tc51.c51_target(_t(pns), torch.from_numpy(a_star), _t(ret), _t(nt),
                          0.99 ** 3, tc51.support_vector(-10, 10, 51, "cpu"),
                          -10.0, 10.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _jax_head_loss(v, a, actions, m, w, n_act):
    """The JAX package's loss head (agent.py:126-134 after the streams)."""
    vv = v.reshape(-1, 1, 51)
    aa = a.reshape(-1, n_act, 51)
    q = (vv + aa - aa.mean(axis=1, keepdims=True)).astype(jnp.float32)
    log_ps = jax.nn.log_softmax(q, axis=2)
    log_a = jnp.take_along_axis(log_ps, actions[:, None, None], 1)[:, 0]
    losses = jc51.c51_loss(log_a, m)
    return (w * losses).mean(), losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_loss_value_and_gradient_match_jax(dtype):
    rng = np.random.default_rng(3)
    b = 5
    v = (rng.normal(size=(b, 51)) * 2).astype(np.float32)
    a = (rng.normal(size=(b, A * 51)) * 2).astype(np.float32)
    actions = rng.integers(0, A, b).astype(np.int32)
    m = rng.dirichlet(np.ones(51), b).astype(np.float32)
    w = rng.uniform(0.1, 1.0, b).astype(np.float32)
    jdt = getattr(jnp, dtype)
    (want, want_losses), (dv_j, da_j) = jax.value_and_grad(
        _jax_head_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(v, jdt), jnp.asarray(a, jdt), jnp.asarray(actions),
        jnp.asarray(m), jnp.asarray(w), A)
    tdt = getattr(torch, dtype)
    tv = _t(v).to(tdt).requires_grad_()
    ta = _t(a).to(tdt).requires_grad_()
    losses, loss = tc51.head_loss(tv, ta, torch.from_numpy(actions), _t(m),
                                  _t(w))
    dv, da = torch.autograd.grad(loss * 2.0, (tv, ta))  # backward scales
    # The loss is float32 on both sides, from logits that agree to the
    # streams' precision.
    tol = F32 if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(loss.item(), float(want), **tol)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), **tol)
    gtol = dict(atol=1e-6, rtol=1e-4) if dtype == "float32" else BF16
    assert dv.dtype == tdt and da.dtype == tdt
    np.testing.assert_allclose(dv.float().numpy(), 2 * _n(dv_j), **gtol)
    np.testing.assert_allclose(da.float().numpy(), 2 * _n(da_j), **gtol)


# --------------------------------------------------------- noisy layer -----

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", ["none", "shared", "row"])
def test_noisy_linear_backward_matches_jax_grad(mode, relu, dtype):
    rng = np.random.default_rng(4)
    b, n_in, n_out = 5, 48, 24
    jp = {"w_mu": rng.uniform(-0.2, 0.2, (n_out, n_in)),
          "w_sigma": rng.uniform(0.0, 0.1, (n_out, n_in)),
          "b_mu": rng.uniform(-0.2, 0.2, n_out),
          "b_sigma": rng.uniform(0.0, 0.1, n_out)}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in jp.items()}
    x = rng.normal(size=(b, n_in)).astype(np.float32)
    cot = rng.normal(size=(b, n_out)).astype(np.float32)
    lead = (b,) if mode == "row" else ()
    eps = None if mode == "none" else (
        rng.normal(size=lead + (n_in,)).astype(np.float32),
        rng.normal(size=lead + (n_out,)).astype(np.float32))
    jdt = getattr(jnp, dtype)

    def f(params, xx):
        y = jnoisy.noisy_linear(params, xx, None, eps=None if eps is None
                                else tuple(map(jnp.asarray, eps)))
        if relu:
            y = jax.nn.relu(y)
        return (y.astype(jnp.float32) * cot).sum()
    gp, gx = jax.grad(f, argnums=(0, 1))(jp, jnp.asarray(x, jdt))

    tdt = getattr(torch, dtype)
    names = {"w_mu": "weight_mu", "w_sigma": "weight_sigma",
             "b_mu": "bias_mu", "b_sigma": "bias_sigma"}
    tp = {names[k]: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in jp.items()}
    tx = _t(x).to(tdt).requires_grad_()
    y = tnoisy.noisy_linear(tp, tx, None if eps is None
                            else tuple(map(_t, eps)), relu=relu)
    (y.float() * _t(cot)).sum().backward()
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "float32" else BF16
    assert tx.grad.dtype == tdt
    np.testing.assert_allclose(tx.grad.float().numpy(), _n(gx), **tol)
    for jk, tk in names.items():
        assert tp[tk].grad.dtype == torch.float32
        np.testing.assert_allclose(tp[tk].grad.numpy(), _n(gp[jk]), **tol,
                                   err_msg=tk)


# -------------------------------------------------------------- agent ------

def _agents(jcfg, tcfg, seed=0):
    """A JAX agent and the port's agent with the same params and state."""
    ja = jag.init_agent(jax.random.key(seed), jcfg, A)
    ta = tag.AgentState(
        params=_flat(ja.params), target_params=_flat(ja.target_params),
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, ja.opt_state),
                                     device="cpu"),
        generator=torch.Generator().manual_seed(seed))
    return ja, ta


def _batch(rng, b=BS):
    s = rng.integers(0, 256, (b, 84, 84, 4)).astype(np.float32) / 255
    ns = rng.integers(0, 256, (b, 84, 84, 4)).astype(np.float32) / 255
    return {"states": s, "next_states": ns,
            "actions": rng.integers(0, A, b).astype(np.int32),
            "returns": rng.uniform(-2, 2, b).astype(np.float32),
            "nonterminals": (rng.random(b) > 0.3).astype(np.float32),
            "weights": rng.uniform(0.2, 1.0, b).astype(np.float32)}


def test_compute_update_pretarget_matches_jax():
    jcfg, tcfg = _configs()
    ja, ta = _agents(jcfg, tcfg)
    rng = np.random.default_rng(5)
    batch = _batch(rng)
    pns_target = rng.dirichlet(np.ones(51), (BS, A)).astype(np.float32)
    eps = jdqn.draw_noise(jcfg, A, jax.random.key(9))
    update = jax.jit(jag.compute_update_pretarget,
                     static_argnames=("cfg", "action_space"))
    grads, losses, _ = update(
        ja, jcfg, A, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(pns_target), noise_eps=eps)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tgrads, tlosses = tag.compute_update_pretarget(
        ta, tcfg, A, tbatch, _t(pns_target), _eps_to_torch(eps))
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(losses), **F32)
    want = _flat(grads)
    scale = max(float(v.abs().max()) for v in want.values())
    _assert_dicts_close(tgrads, want, atol=1e-5 * scale, rtol=1e-4)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["below", "above"])
def test_apply_grads_matches_optax_over_three_steps(clip, mu_dtype):
    jcfg, tcfg = _configs(adam_mu_dtype=mu_dtype)
    ja, _ = _agents(jcfg, tcfg)
    rng = np.random.default_rng(6)
    # Global norm about 0.3 ("below" 10) or about 300 ("above").
    scale = 1e-4 if clip == "below" else 1e-1
    def grads():
        return jax.tree.map(lambda p: jnp.asarray(
            rng.normal(size=p.shape) * scale, jnp.float32), ja.params)
    # One step in JAX first, so the state carried across is not all zeros.
    ja = jag.apply_grads(ja, jcfg, grads(), ja.rng)
    ta = tag.AgentState(
        params=_flat(ja.params), target_params=_flat(ja.target_params),
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, ja.opt_state),
                                     device="cpu"),
        generator=torch.Generator())
    assert int(ta.opt_state.count) == 1
    want_dtype = getattr(torch, mu_dtype)
    assert all(v.dtype == want_dtype for v in ta.opt_state.mu.values())
    for _ in range(3):
        g = grads()
        norm = float(jnp.sqrt(sum(jnp.sum(x * x)
                                  for x in jax.tree.leaves(g))))
        assert (norm < 10) == (clip == "below")
        ja = jag.apply_grads(ja, jcfg, g, ja.rng)
        tag.apply_grads(ta, tcfg, _flat(g))
        adam = ja.opt_state[1][0]
        assert int(ta.opt_state.count) == int(adam.count)
        # A bf16 mu that rounds one ulp apart moves u by up to 2^-7.
        p_tol = 1e-7 if mu_dtype == "float32" else 3 * 6.25e-5 * 2 ** -7
        _assert_dicts_close(ta.params, _flat(ja.params), atol=p_tol, rtol=0)
        _assert_dicts_close(ta.opt_state.nu, _flat(adam.nu), atol=0,
                            rtol=1e-5)
        # mu crosses zero, so it is held to a share of its tensor's largest
        # value: 1e-6 in float32, one bf16 ulp (2^-8) in bfloat16, where a
        # rounding that fell the other way carries into later steps.
        want_mu = _flat(adam.mu)
        for k, want in want_mu.items():
            _assert_dicts_close(
                {k: ta.opt_state.mu[k]}, {k: want}, rtol=0,
                atol=float(want.float().abs().max())
                * (1e-6 if mu_dtype == "float32" else 2 ** -8))
    assert ta.step == 3


def test_update_target_copies_online_params():
    jcfg, tcfg = _configs()
    _, ta = _agents(jcfg, tcfg)
    for v in ta.params.values():
        v.add_(1.0)
    tag.update_target(ta)
    _assert_dicts_close(ta.target_params, ta.params, atol=0, rtol=0)
    assert all(ta.target_params[k] is not ta.params[k] for k in ta.params)


# -------------------------------------------------------------- replay -----

def _replay(seed=7, index=5, full=True, c=C):
    """The same random ring in both packages: random frames and rewards,
    episode starts about every 6 steps, random priorities with some zeros;
    ``c`` columns an env."""
    rng = np.random.default_rng(seed)
    ts = np.zeros((E, c), np.int32)
    for e in range(E):
        t = 0
        for col in range(c):
            ts[e, col] = t
            t = 0 if rng.random() < 0.17 else t + 1
    pr = rng.gamma(2.0, 1.0, (E, c)).astype(np.float32)
    pr[rng.random((E, c)) < 0.1] = 0.0
    fields = dict(
        frames=rng.integers(0, 256, (E, c, 84 * 84)).astype(np.uint8),
        actions=rng.integers(0, A, (E, c)).astype(np.int32),
        rewards=rng.normal(size=(E, c)).astype(np.float32),
        timesteps=ts, nonterminal=rng.random((E, c)) > 0.1, priorities=pr,
        index=np.int32(index), full=np.bool_(full),
        t=rng.integers(0, 9, E).astype(np.int32),
        max_priority=np.float32(pr.max()))
    j = jrp.init_replay(E, c).replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    t = trp.ReplayState(**{k: torch.from_numpy(np.array(v))
                           for k, v in fields.items()})
    return j, t


def _assert_same_replay(t, j, close=("priorities", "max_priority"),
                        tol=F32):
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name).numpy(), np.asarray(getattr(j, f.name))
        if f.name in close:
            np.testing.assert_allclose(got, want, **tol, err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


@pytest.mark.parametrize("full", [True, False])
def test_sample_many_matches_jax(full):
    j, t = _replay(full=full, index=20)
    nb = 3
    key = jax.random.key(11)
    want = jrp.sample_many(j, key, 0.6, num_batches=nb, batch_size=BS,
                           history=4, n_step=3, discount=0.99,
                           states_uint8=True)
    u = _t(jax.random.uniform(key, (nb * BS,), jnp.float32))
    got = trp.sample_many(t, 0.6, num_batches=nb, batch_size=BS, history=4,
                          n_step=3, discount=0.99, u=u)
    assert got.keys() == want.keys()
    for k in ("idxs", "states", "next_states", "actions", "nonterminals"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["states"].dtype == torch.uint8
    for k in ("returns", "weights", "weights_max"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    # Per-batch normalisation: every batch's largest weight is 1, and
    # segment j went to batch j % nb.
    np.testing.assert_allclose(got["weights"].amax(dim=1).numpy(), 1.0)
    flat = trp._masked_flat_priorities(t, 4, 3)
    idx, _, _ = trp._stratified_find(flat, nb * BS, u=u)
    np.testing.assert_array_equal(got["idxs"].numpy(),
                                  idx.view(BS, nb).T.numpy())


def test_sampling_an_empty_ring_gives_zero_weights_not_nan():
    _, t = _replay()
    t.priorities.zero_()
    out = trp.sample_many(t, 0.4, num_batches=2, batch_size=BS, history=4,
                          n_step=3, discount=0.99,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(out["weights"], torch.zeros(2, BS))


def test_update_priorities_matches_jax_and_duplicates_keep_a_candidate():
    j, t = _replay()
    idxs = np.array([3, 40, 77, 127, 64], np.int64)
    losses = np.array([0.5, 4.0, 9.0, 0.01, 2.25], np.float32)
    j2 = jrp.update_priorities(j, jnp.asarray(idxs), jnp.asarray(losses), 0.5)
    out = trp.update_priorities(t, torch.from_numpy(idxs), _t(losses), 0.5)
    assert out is t
    np.testing.assert_array_equal(t.priorities.numpy(),
                                  np.asarray(j2.priorities))
    assert float(t.max_priority) == float(j2.max_priority)
    # A repeated index ends with one of its candidates; the max is over all.
    trp.update_priorities(t, torch.tensor([9, 9, 10]),
                          _t([0.25, 16.0, 1.0]), 0.5)
    assert float(t.priorities.view(-1)[9]) in (0.5, 4.0)
    assert float(t.max_priority) == max(4.0, float(j2.max_priority))


# ------------------------------------------------------ round and iter -----

def _round_draws(jcfg, key, num_learns):
    """The draws JAX's batched round makes from ``key`` (train.py:376-396)."""
    k_sample, k_target, k_noise = jax.random.split(key, 3)
    nrows = num_learns * jcfg.batch_size
    return {"u": _t(jax.random.uniform(k_sample, (nrows,), jnp.float32)),
            "target": _eps_to_torch(jdqn.draw_noise(jcfg, A, k_target,
                                                    lead=(nrows,))),
            "online": _eps_to_torch(jdqn.draw_noise(jcfg, A, k_noise,
                                                    lead=(num_learns,)))}


def _assert_agent_close(ta, ja, before, num_learns, lr=6.25e-5):
    """Params and target params as JAX's to lr/100; with updates, every
    param tensor moved from ``before`` by more than that, else not at all."""
    tol = lr / 100
    _assert_dicts_close(ta.params, _flat(ja.params), atol=tol, rtol=0)
    _assert_dicts_close(ta.target_params, _flat(ja.target_params), atol=tol,
                        rtol=0)
    assert int(ta.opt_state.count) == int(ja.opt_state[1][0].count)
    for k, v in ta.params.items():
        moved = float((v - before[k]).abs().max())
        assert (moved > tol) if num_learns else moved == 0, (k, moved)


def _update_errors(got, want, before, update_rel):
    """Each tensor's update got - before against JAX's want - before:
    {key: (the difference's norm as a share of JAX's update's norm, the
    bound update_rel gives its kind: "convs", a noisy layer's "weight" or
    "bias")}."""
    out = {}
    for k, base in before.items():
        kind = ("convs" if k.startswith("convs.")
                else "weight" if ".weight_" in k else "bias")
        dt, dj = got[k] - base, want[k] - base
        out[k] = (float((dt - dj).norm()) / max(float(dj.norm()), 1e-30),
                  update_rel[kind])
    return out


def _assert_round_agent_close(ta, ja, before, num_learns, lr, update_rel):
    """The agent after a round as JAX's, held as ROUND_CASES says: without
    ``update_rel`` each param to lr/100 (_assert_agent_close), else each
    param and target tensor's change from ``before`` within its kind's
    share of JAX's change in norm (_update_errors), every param tensor
    moved, Adam's count equal."""
    if update_rel is None:
        _assert_agent_close(ta, ja, before, num_learns, lr)
        return
    assert int(ta.opt_state.count) == int(ja.opt_state[1][0].count)
    for got, want in ((ta.params, _flat(ja.params)),
                      (ta.target_params, _flat(ja.target_params))):
        assert got.keys() == want.keys()
        for k, (err, bound) in _update_errors(got, want, before,
                                              update_rel).items():
            assert err <= bound, (k, err, bound)
    for k, v in ta.params.items():
        moved = float((v - before[k]).abs().max())
        assert (moved > 0) if num_learns else moved == 0, (k, moved)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_learner_round_matches_jax(case):
    jcfg, tcfg, nl, c, update_rel, _ = _round_case(case)
    ja, ta = _agents(jcfg, tcfg)
    j, t = _replay(index=9, c=c)
    beta, key = 0.55, jax.random.key(21)
    draws = _round_draws(jcfg, key, nl)
    j_before = jax.tree.map(np.array, j)
    params0 = {k: v.clone() for k, v in ta.params.items()}
    ja, j2, jloss = jtrain.learner_round(ja, j, jcfg, A, nl, beta, key)
    loss = ttrain.learner_round(ta, t, tcfg, A, nl, beta, draws)
    flat = trp._masked_flat_priorities(
        trp.ReplayState(**{k: torch.from_numpy(np.array(v)) for k, v in
                           dataclasses.asdict(j_before).items()}),
        tcfg.history_length, tcfg.multi_step)
    rows = nl * tcfg.batch_size
    idx, _, _ = trp._stratified_find(flat, rows, u=draws["u"])
    assert len(set(idx.tolist())) == rows  # no duplicate write-backs here
    ltol = F32 if tcfg.compute_dtype == "float32" else BF16
    np.testing.assert_allclose(loss.item(), float(jloss), **ltol)
    _assert_round_agent_close(ta, ja, params0, nl, tcfg.learning_rate,
                              update_rel)
    _assert_same_replay(t, j2, tol=ltol)
    changed = t.priorities.numpy() != j_before.priorities
    assert changed.sum() == rows


def test_bf16_round_check_refuses_a_dropped_chunk(monkeypatch):
    """A control for BF16_UPDATE: test_learner_round_matches_jax's bf16
    round with the port's noisy-linear backward given x without its first
    256 input features, as a kernel that dropped one of its input chunks
    would compute it, puts every noisy layer's weight updates beyond their
    bound."""
    jcfg, tcfg, nl, c, update_rel, _ = _round_case("bfloat16")
    ja, ta = _agents(jcfg, tcfg)
    j, t = _replay(index=9, c=c)
    beta, key = 0.55, jax.random.key(21)
    draws = _round_draws(jcfg, key, nl)
    params0 = {k: v.clone() for k, v in ta.params.items()}
    real = tnoisy.noisy_linear_bwd_plain

    def dropped(w_mu, w_sig, x, g, eps=None, y=None):
        x = x.clone()
        x[:, :256] = 0
        return real(w_mu, w_sig, x, g, eps, y)

    monkeypatch.setattr(tnoisy, "noisy_linear_bwd_plain", dropped)
    ja, _, _ = jtrain.learner_round(ja, j, jcfg, A, nl, beta, key)
    ttrain.learner_round(ta, t, tcfg, A, nl, beta, draws)
    errs = _update_errors(ta.params, _flat(ja.params), params0, update_rel)
    weights = {k: e for k, e in errs.items() if ".weight_" in k}
    assert len(weights) == 8
    for k, (err, bound) in weights.items():
        assert err > bound, (k, err, bound)


def test_sequential_per_round_raises_until_ported(monkeypatch):
    """The sequential PER round is ported: with cfg.sequential_per,
    learner_round and train_iter_packed run it, as JAX's dispatch
    (train.py:266, 457), and raise no more: one prioritized sample per
    update, against the priorities the update before wrote."""
    cfg = rainbow_tpu_torch.canonical(**KW, sequential_per=True)
    _, t = _replay()
    ta = tag.init_agent(cfg, A, 0, "cpu")
    sampled = []
    real_sample = trp.sample

    def sample(state, *args, **kw):
        sampled.append(state.priorities.clone())
        return real_sample(state, *args, **kw)
    monkeypatch.setattr(trp, "sample", sample)
    loss = ttrain.learner_round(ta, t, cfg, A, 2, 0.5)
    assert np.isfinite(loss.item()) and len(sampled) == 2
    assert not torch.equal(sampled[0], sampled[1])  # the first wrote back
    step = [torch.zeros((E, 84, 84), dtype=torch.uint8),
            torch.zeros((0, 84, 84), dtype=torch.uint8),
            torch.zeros(0, dtype=torch.int32), torch.zeros(E),
            torch.zeros(E, dtype=torch.bool),
            torch.zeros(E, dtype=torch.uint8)]
    stack = torch.zeros((E, 84, 84, 4), dtype=torch.uint8)
    prev = torch.zeros(E, dtype=torch.int64)
    ttrain.train_iter_packed(cfg, A, 1, ta, stack, t, prev, *step, 0.5,
                             False)
    assert len(sampled) == 3
    assert ta.step == 3 and int(ta.opt_state.count) == 3


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_train_iter_packed_matches_jax(case):
    """A warm-up iteration, then two fused ones: the round reads the
    pre-append replay, the target stays as it was without the sync and
    becomes a copy of the updated params with it, and the act that follows
    uses fresh noise."""
    jcfg, tcfg, n_learns, c, update_rel, gap = _round_case(case)
    ltol = F32 if tcfg.compute_dtype == "float32" else BF16
    ja, ta = _agents(jcfg, tcfg)
    j, t = _replay(index=9, c=c)
    rng = np.random.default_rng(8)
    stack = rng.integers(0, 256, (E, 84, 84, 4)).astype(np.uint8)
    js, ts = jnp.asarray(stack), torch.from_numpy(stack.copy())
    loop_key = jax.random.key(31)
    prev = rng.integers(0, A, E)
    jprev, tprev = jnp.asarray(prev), torch.from_numpy(prev)
    target0 = {k: v.clone() for k, v in ta.target_params.items()}
    for nl, sync in ((0, False), (n_learns, False), (n_learns, True)):
        kinds = np.array([0, 1, 0, 2], np.uint8)
        obs = rng.integers(0, 256, (E, 84, 84)).astype(np.uint8)
        resets = rng.integers(0, 256, (E, 84, 84)).astype(np.uint8)
        packed, ridx = pack_resets(resets, kinds)
        rewards = rng.normal(size=E).astype(np.float32)
        dones = kinds > 0
        step = (obs, packed, ridx, rewards, dones, kinds)
        # The draws JAX makes inside this iteration (train.py:262-280).
        draws = {}
        noise_key = ja.noise_key
        if nl:
            _, k = jax.random.split(loop_key)
            draws = _round_draws(jcfg, k, nl)
            noise_key = jax.random.fold_in(jax.random.fold_in(noise_key, 1), 1)
        draws["act"] = _eps_to_torch(jdqn.draw_noise(jcfg, A, noise_key,
                                                     lead=(E,)))
        params0 = {k: v.clone() for k, v in ta.params.items()}
        jact, ja, js, j, loop_key, jloss = jtrain.train_iter_packed(
            jcfg, A, nl, ja, js, j, loop_key, jprev,
            *map(jnp.asarray, step), 0.5, sync)
        tact, tloss = ttrain.train_iter_packed(
            tcfg, A, nl, ta, ts, t, tprev, *map(torch.from_numpy, step), 0.5,
            sync, draws)
        np.testing.assert_allclose(tloss.item(), float(jloss), **ltol)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _assert_same_replay(t, j, tol=ltol)
        _assert_round_agent_close(ta, ja, params0, nl, tcfg.learning_rate,
                                  update_rel)
        if sync:
            _assert_dicts_close(ta.target_params, ta.params, atol=0, rtol=0)
        else:
            _assert_dicts_close(ta.target_params, target0, atol=0, rtol=0)
        q = forward_head(ta.params, tcfg, A, to_network_input(ts),
                         noise_eps=draws["act"]).q
        top2 = q.topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > gap
        assert clear.any()
        np.testing.assert_array_equal(tact[clear].numpy(),
                                      np.asarray(jact)[clear.numpy()])
        jprev, tprev = jact, torch.from_numpy(np.array(jact))
