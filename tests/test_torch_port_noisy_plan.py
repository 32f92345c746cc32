"""The noisy-linear kernels' launch plans (kernels/noisy_linear.py), on the
CPU: how the forward splits its inputs and the backward its outputs into
chunks, which path each shape of the main path takes, the grid and the
scratch they give, and the split's arithmetic: the plan's chunks run
through plain torch, their partial sums added in the plan's order, against
noisy_linear_plain / noisy_linear_bwd_plain and the JAX package's
noisy_linear and its gradient, on the same numpy inputs.

Tolerance: float32 on every side, differing only in the order of sums of
up to a few hundred O(1) terms, so 1e-5 absolute and relative. The bf16
plan's split, with the tensor-core kernels' rounding (operands rounded as
the JAX package casts them, fp32 sums, one rounding at the end), against
the plain version and the JAX package in bf16, which round after every op:
a few bf16 ulps of O(1) values, the card tests' (6e-2, 3e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu.models import noisy as jnoisy

from rainbow_tpu_torch.kernels.noisy_linear import (CHUNK_MAX, KT, WAVE,
                                                    bwd_plan, fwd_plan)
from rainbow_tpu_torch.models.noisy import (noisy_linear_bwd_plain,
                                            noisy_linear_plain)

F32 = dict(atol=1e-5, rtol=1e-5)
A = 6  # pong's actions: fc_z_a is 512 -> 306
LAYERS = [(3136, 512), (512, 51), (512, A * 51)]
# Batches of the main path: the learner's update forwards and backward (32),
# evaluation (10), the validation chunks (250), the actor (1024) and the
# round's target forward (8192); and the edges (1, 33, 3137 and 513).
SHAPES = [(b, i, o) for b in (1, 10, 32, 33, 250, 1024, 8192)
          for i, o in LAYERS + [(3137, 513)]]


def _tiles_once(chunks, n, plan):
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(e > s for s, e in chunks)
    assert all((e - s) % KT == 0 for s, e in chunks[:-1])
    assert len(chunks) == plan.splits


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fwd_chunks_tile_the_inputs_once_in_order(mode):
    for b, n_in, n_out in SHAPES:
        plan = fwd_plan(b, n_in, n_out, mode)
        _tiles_once(plan.chunks(n_in), n_in, plan)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bwd_dx_chunks_tile_the_outputs_once_in_order(mode):
    for b, n_in, n_out in SHAPES:
        plan = bwd_plan(b, n_in, n_out, mode)
        _tiles_once(plan.chunks(n_out), n_out, plan)


def test_paths_at_the_main_path_shapes():
    for b in (1, 10, 32, 250):  # learner, evaluation, validation chunks
        for n_in, n_out in LAYERS:
            assert fwd_plan(b, n_in, n_out, 1).path == "small", (b, n_out)
    for b in (1024, 8192):  # actor, round target
        for n_in, n_out in [(3136, 512), (512, A * 51)]:
            assert fwd_plan(b, n_in, n_out, 2).path == "large", (b, n_out)
    assert fwd_plan(8192, 512, 51, 2).path == "large"
    # 1024 x 51: 32 small tiles leave most SMs idle, so it splits instead.
    assert fwd_plan(1024, 512, 51, 2).path == "small"
    assert fwd_plan(10, 512, 51, 0).tile == 16
    assert fwd_plan(32, 3136, 512, 1).tile == 32


def test_small_path_chunks_fit_a_blocks_staged_x():
    for b, n_in, n_out in SHAPES:
        plan = fwd_plan(b, n_in, n_out, 1)
        if plan.path == "small":
            assert plan.chunk <= CHUNK_MAX, (b, n_in, n_out)
    assert fwd_plan(250, 3136, 512, 2).chunk == CHUNK_MAX


def test_split_fills_a_wave_at_the_learners_fc_h():
    fwd = fwd_plan(32, 3136, 512, 1)
    assert (fwd.chunk, fwd.splits) == (192, 17)
    assert fwd.blocks == 8 * 17 >= WAVE
    bwd = bwd_plan(32, 3136, 512, 1)
    assert (bwd.chunk, bwd.splits) == (176, 3)
    assert bwd.blocks == 49 * 3 >= WAVE
    # Large path: whole waves only (one heavy block per SM).
    act = fwd_plan(1024, 3136, 512, 2)
    assert (act.tile, act.splits, act.blocks) == (128, 4, 128)
    assert fwd_plan(8192, 3136, 512, 2).splits == 1


def test_scratch_holds_one_plane_per_accumulator_and_split():
    for mode, planes in ((0, 1), (1, 2), (2, 2)):
        fwd = fwd_plan(32, 3136, 512, mode)
        assert fwd.scratch == planes * fwd.splits * 32 * 512
        bwd = bwd_plan(32, 3136, 512, mode)
        assert bwd.scratch == planes * bwd.splits * 32 * 3136
    assert fwd_plan(8192, 3136, 512, 2).scratch == 0  # no split
    assert bwd_plan(1024, 3136, 512, 1).scratch == 0


def _inputs(rng, b, n_in, n_out, mode):
    j = {"w_mu": rng.uniform(-0.2, 0.2, (n_out, n_in)),
         "w_sigma": rng.uniform(0.0, 0.1, (n_out, n_in)),
         "b_mu": rng.uniform(-0.2, 0.2, n_out),
         "b_sigma": rng.uniform(0.0, 0.1, n_out)}
    j = {k: np.asarray(v, np.float32) for k, v in j.items()}
    x = rng.uniform(0.0, 2.0, (b, n_in)).astype(np.float32)
    lead = (b,) if mode == 2 else ()
    eps = None if mode == 0 else tuple(
        rng.standard_normal(lead + (n,)).astype(np.float32)
        for n in (n_in, n_out))
    return j, x, eps


def _split_fwd(w, x, eps, plan):
    """The forward as the split path computes it: per chunk a partial sum
    of each accumulator, added in chunk order, then the epilogue."""
    mu = sig = 0.0
    xe = x * eps[0] if eps is not None else None
    for s, e in plan.chunks(x.shape[1]):
        mu = mu + x[:, s:e] @ w["weight_mu"][:, s:e].T
        if eps is not None:
            sig = sig + xe[:, s:e] @ w["weight_sigma"][:, s:e].T
    y = mu + w["bias_mu"]
    if eps is not None:
        y = y + sig * eps[1] + w["bias_sigma"] * eps[1]
    return y


# Shapes whose plans split: small path (tile 16 and 32) and large path.
SPLIT_SHAPES = [(5, 70, 20), (37, 301, 70), (600, 200, 800)]


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_split_forward_matches_plain_and_jax(mode):
    rng = np.random.default_rng(mode)
    for b, n_in, n_out in SPLIT_SHAPES:
        plan = fwd_plan(b, n_in, n_out, mode)
        assert plan.splits > 1
        j, x, eps = _inputs(rng, b, n_in, n_out, mode)
        w = {"weight_mu": j["w_mu"], "weight_sigma": j["w_sigma"],
             "bias_mu": j["b_mu"], "bias_sigma": j["b_sigma"]}
        w = {k: torch.from_numpy(v) for k, v in w.items()}
        teps = None if eps is None else tuple(map(torch.from_numpy, eps))
        got = _split_fwd(w, torch.from_numpy(x), teps, plan)
        plain = noisy_linear_plain(w, torch.from_numpy(x), teps)
        want = jnoisy.noisy_linear({k: jnp.asarray(v) for k, v in j.items()},
                                   jnp.asarray(x), None, eps=eps)
        torch.testing.assert_close(got, plain, **F32)
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                                   **F32)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_split_dx_matches_plain_and_jax(mode):
    """dx as the backward's split computes it: per chunk of outputs a
    partial sum of g @ mu_w and of (g * eps_out) @ sigma_w, added in chunk
    order, then scaled by eps_in; against noisy_linear_bwd_plain and
    jax.vjp of the JAX package's noisy_linear."""
    rng = np.random.default_rng(10 + mode)
    for b, n_in, n_out in [(5, 70, 90), (33, 64, 513)]:
        plan = bwd_plan(b, n_in, n_out, mode)
        assert plan.splits > 1
        j, x, eps = _inputs(rng, b, n_in, n_out, mode)
        g = rng.standard_normal((b, n_out)).astype(np.float32)
        wm, ws = torch.from_numpy(j["w_mu"]), torch.from_numpy(j["w_sigma"])
        tg = torch.from_numpy(g)
        teps = None if eps is None else tuple(map(torch.from_numpy, eps))
        mu = sig = 0.0
        for s, e in plan.chunks(n_out):
            mu = mu + tg[:, s:e] @ wm[s:e]
            if eps is not None:
                sig = sig + (tg * teps[1])[:, s:e] @ ws[s:e]
        got = mu if eps is None else mu + sig * teps[0]
        plain = noisy_linear_bwd_plain(wm, ws, torch.from_numpy(x), tg, teps)
        jparams = {k: jnp.asarray(v) for k, v in j.items()}
        _, vjp = jax.vjp(lambda xx: jnoisy.noisy_linear(jparams, xx, None,
                                                         eps=eps),
                         jnp.asarray(x))
        want = np.array(vjp(jnp.asarray(g))[0])
        torch.testing.assert_close(got, plain[0], **F32)
        torch.testing.assert_close(got, torch.from_numpy(want), **F32)


def _bf16_split_fwd(w, x, eps, plan):
    """The bf16 forward as the tensor-core kernels compute it: the weights,
    eps and biases rounded to bf16, x * eps_in rounded once; per chunk fp32
    partial sums of the exact bf16 products, added in chunk order; the
    epilogue in fp32 and one rounding to bf16."""
    r = lambda t: t.to(torch.bfloat16).float()
    xf = x.float()
    wm, ws = r(w["weight_mu"]), r(w["weight_sigma"])
    xe = None if eps is None else r(xf * r(eps[0]))
    mu = sig = 0.0
    for s, e in plan.chunks(x.shape[1]):
        mu = mu + xf[:, s:e] @ wm[:, s:e].T
        if eps is not None:
            sig = sig + xe[:, s:e] @ ws[:, s:e].T
    y = mu + r(w["bias_mu"])
    if eps is not None:
        eo = r(eps[1])
        y = y + sig * eo + r(w["bias_sigma"]) * eo
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bf16_split_forward_matches_plain_and_jax(mode):
    """The bf16 plan splits these shapes on its small path (tiles 16 and
    32) and its large path; its chunk-ordered sums match
    noisy_linear_plain and the JAX package's noisy_linear in bf16."""
    rng = np.random.default_rng(20 + mode)
    bf16 = dict(atol=6e-2, rtol=3e-2)
    for b, n_in, n_out in SPLIT_SHAPES:
        plan = fwd_plan(b, n_in, n_out, mode, torch.bfloat16)
        assert plan.splits > 1
        j, x, eps = _inputs(rng, b, n_in, n_out, mode)
        w = {"weight_mu": j["w_mu"], "weight_sigma": j["w_sigma"],
             "bias_mu": j["b_mu"], "bias_sigma": j["b_sigma"]}
        w = {k: torch.from_numpy(v) for k, v in w.items()}
        teps = None if eps is None else tuple(map(torch.from_numpy, eps))
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got = _bf16_split_fwd(w, xb, teps, plan).float()
        plain = noisy_linear_plain(w, xb, teps).float()
        want = jnoisy.noisy_linear(
            {k: jnp.asarray(v) for k, v in j.items()},
            jnp.asarray(x).astype(jnp.bfloat16), None, eps=eps)
        torch.testing.assert_close(got, plain, **bf16)
        torch.testing.assert_close(
            got, torch.from_numpy(np.array(want.astype(jnp.float32))), **bf16)
