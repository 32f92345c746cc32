"""The noisy-linear kernels' launch plans (kernels/noisy_linear.py), on the
CPU: how the forward splits its inputs and the backward its outputs into
chunks, which path each shape of the main path takes, the grid and the
scratch they give, and the split's arithmetic: the plan's chunks run
through plain torch, their partial sums added in the plan's order, against
noisy_linear_plain / noisy_linear_bwd_plain and the JAX package's
noisy_linear and its gradient, on the same numpy inputs. For the float32
backward's large path also its split of the batch, and its two-product
form (W_eff, dσ_W = dμ_W ⊙ ε_out ε_inᵀ) against the plain backward in
float64.

Tolerance: float32 on every side, differing only in the order of sums of
up to a few hundred O(1) terms, so 1e-5 absolute and relative. The bf16
plan's split, with the tensor-core kernels' rounding (operands rounded as
the JAX package casts them, fp32 sums, one rounding at the end), against
the plain version and the JAX package in bf16, which round after every op:
a few bf16 ulps of O(1) values, the card tests' (6e-2, 3e-2).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu.models import noisy as jnoisy

from rainbow_tpu_torch.kernels.noisy_linear import (BWD_CHUNK_MIN,
                                                    BWD_LARGE_ROWS, BWD_TILE,
                                                    CHUNK_MAX, KT, WAVE,
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


def _tiles_once(chunks, n, splits):
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(e > s for s, e in chunks)
    assert all((e - s) % KT == 0 for s, e in chunks[:-1])
    assert len(chunks) == splits


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fwd_chunks_tile_the_inputs_once_in_order(mode):
    for b, n_in, n_out in SHAPES:
        plan = fwd_plan(b, n_in, n_out, mode)
        _tiles_once(plan.chunks(n_in), n_in, plan.splits)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bwd_dx_chunks_tile_the_outputs_once_in_order(mode):
    for b, n_in, n_out in SHAPES:
        plan = bwd_plan(b, n_in, n_out, mode)
        _tiles_once(plan.chunks(n_out), n_out, plan.splits)


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
    # The canonical cell's fc_h backward: the large path, unsplit, 100
    # weight tiles of K 1,024 and 200 dx tiles of K 512.
    large = bwd_plan(1024, 3136, 512, 1)
    assert (large.path, large.tile) == ("large", 128)
    assert (large.chunk, large.splits) == (512, 1)
    assert (large.w_chunk, large.w_splits) == (1024, 1)
    assert large.blocks == 4 * 25 + 8 * 25 == 300
    assert large.scratch == 0


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


# ------------------------------------------------ the large backward ----

FC_LAYERS = LAYERS + [(576, 256)]  # and the data-efficient net's fc_h


def test_bwd_paths_at_the_main_path_shapes():
    """float32 with no or shared noise takes the large path from
    BWD_LARGE_ROWS rows up: the throughput preset's B = 256 and the
    canonical cell's 1,024 (every layer: the rule reads the batch, not the
    layer); the learners' B = 32, per-row noise and every bf16 call keep
    the small path."""
    assert 32 < BWD_LARGE_ROWS <= 256
    for n_in, n_out in FC_LAYERS + [(3137, 513)]:
        for mode in (0, 1):
            assert bwd_plan(32, n_in, n_out, mode).path == "small"
            for b in (256, 1024, 2048):
                assert bwd_plan(b, n_in, n_out, mode).path == "large"
                assert bwd_plan(b, n_in, n_out, mode,
                                torch.bfloat16).path == "small"
        for b in (32, 256, 1024):
            assert bwd_plan(b, n_in, n_out, 2).path == "small"
    for b in (1, BWD_LARGE_ROWS - 1):
        assert bwd_plan(b, 3136, 512, 1).path == "small"
    assert bwd_plan(BWD_LARGE_ROWS, 3136, 512, 1).path == "large"


LARGE_SHAPES = [(b, i, o) for b in (BWD_LARGE_ROWS, 200, 256, 1024, 2048,
                                    8192)
                for i, o in FC_LAYERS + [(3137, 513), (70, 20)]]


def test_large_bwd_plan_tiles_splits_and_scratch():
    """The large plan's grid is both kinds of 128 x 128 tile, each repeated
    per chunk of its reduction; the chunks cover the outputs (dx) and the
    batch (weights) once, in order, in whole KT steps but the last; a
    reduction is split only while the pieces fill less than a wave, and
    then only its longest chunks, down to BWD_CHUNK_MIN; the scratch holds
    the weight and bias partials (rounded up to 4 floats) and the dx
    partials of a split."""
    for b, n_in, n_out in LARGE_SHAPES:
        for mode in (0, 1):
            p = bwd_plan(b, n_in, n_out, mode)
            assert p.path == "large" and p.tile == BWD_TILE
            _tiles_once(p.chunks(n_out), n_out, p.splits)
            _tiles_once(p.batch_chunks(b), b, p.w_splits)
            k_tiles = math.ceil(n_in / BWD_TILE)
            w_tiles = math.ceil(n_out / BWD_TILE) * k_tiles
            x_tiles = math.ceil(b / BWD_TILE) * k_tiles
            assert p.blocks == w_tiles * p.w_splits + x_tiles * p.splits
            # A reduction is split only where the unsplit tiles leave SMs
            # idle and its whole length is above the floor; the splitting
            # stops once the pieces fill a wave or no chunk is above it.
            for split, n in ((p.splits, n_out), (p.w_splits, b)):
                if split > 1:
                    assert w_tiles + x_tiles < WAVE, (b, n_in, n_out)
                    assert KT * math.ceil(n / KT) > BWD_CHUNK_MIN
            assert (p.blocks >= WAVE
                    or max(p.chunk, p.w_chunk) <= BWD_CHUNK_MIN), (
                        b, n_in, n_out)
            w_part = p.w_splits * (n_out * n_in + n_out) \
                if p.w_splits > 1 else 0
            x_part = p.splits * b * n_in if p.splits > 1 else 0
            assert p.scratch == -(-w_part // 4) * 4 + x_part
            assert bwd_plan(b, n_in, n_out, mode) == p  # pure arithmetic


def test_large_bwd_plan_at_the_cells_and_presets():
    """The splits at the shapes the main path runs: fc_h unsplit from B =
    256 up (the tiles fill a wave); at B = 128 its dx reduction halves;
    pong's fc_z layers, whose 4 or 12 weight tiles would each walk the
    whole batch, split the batch into chunks of at most BWD_CHUNK_MIN (51
    outputs) or enough to fill a wave (306)."""
    got = {(b, o): bwd_plan(b, 3136 if o == 512 else 512, o, 1)
           for b in (128, 256, 1024) for o in (512, 51, 306)}
    want = {(128, 512): (256, 2, 128, 1, 150),
            (256, 512): (512, 1, 256, 1, 150),
            (1024, 512): (512, 1, 1024, 1, 300),
            (1024, 51): (64, 1, 128, 8, 64),
            (1024, 306): (160, 2, 176, 6, 136)}
    for key, (chunk, splits, w_chunk, w_splits, blocks) in want.items():
        p = got[key]
        assert (p.chunk, p.splits, p.w_chunk, p.w_splits, p.blocks) == (
            chunk, splits, w_chunk, w_splits, blocks), (key, p)
    assert got[(1024, 51)].scratch == 8 * (51 * 512 + 51) + 0
    assert got[(1024, 306)].scratch == (6 * (306 * 512 + 306)
                                        + 2 * 1024 * 512)


def _two_products(w_mu, w_sig, x, g, eps, y):
    """The large backward's arithmetic: g masked by y > 0, dx = g @ W_eff
    with W_eff = μ_W + σ_W ⊙ ε_out ε_inᵀ, dμ_W = gᵀ x, dσ_W = dμ_W ⊙ ε_out
    ε_inᵀ, dμ_b = Σ_b g, dσ_b = ε_out ⊙ dμ_b; no σ terms without noise."""
    if y is not None:
        g = torch.where(y > 0, g, torch.zeros_like(g))
    dw_mu = g.T @ x
    db_mu = g.sum(dim=0)
    if eps is None:
        return (g @ w_mu, dw_mu, torch.zeros_like(w_sig), db_mu,
                torch.zeros_like(db_mu))
    outer = eps[1][:, None] * eps[0][None, :]
    return (g @ (w_mu + w_sig * outer), dw_mu, dw_mu * outer, db_mu,
            eps[1] * db_mu)


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("mode", [0, 1])
def test_two_products_equal_the_four_in_float64(mode, relu):
    """With no or shared noise the two-product form gives the plain
    backward's gradients: in float64 they agree to rounding (1e-12 on sums
    of a few hundred O(1) terms). The plain version returns the parameter
    grads as float32, so those are compared after one rounding of the
    float64 two-product grads: to an ulp."""
    rng = np.random.default_rng(40 + 2 * mode + relu)
    for b, n_in, n_out in [(5, 70, 20), (130, 301, 70), (33, 64, 513)]:
        j, x, eps = _inputs(rng, b, n_in, n_out, mode)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        wm, ws, tx = t(j["w_mu"]), t(j["w_sigma"]), t(x)
        g = t(rng.standard_normal((b, n_out)))
        teps = None if eps is None else tuple(map(t, eps))
        y = t(rng.standard_normal((b, n_out))) if relu else None
        got = _two_products(wm, ws, tx, g, teps, y)
        want = noisy_linear_bwd_plain(wm, ws, tx, g, teps, y)
        assert want[0].dtype == got[0].dtype == torch.float64
        for a, c in zip(got, want):
            rtol = 1e-12 if c.dtype == torch.float64 else 2.0 ** -23
            torch.testing.assert_close(a.to(c.dtype), c, atol=1e-12,
                                       rtol=rtol)


@pytest.mark.parametrize("mode", [0, 1])
def test_large_split_matches_plain_and_jax(mode):
    """The large backward as its split computes it, in float32: per chunk
    of the batch a partial dμ_W and bias sum, per chunk of the outputs a
    partial dx over W_eff, each added in chunk order, then the epilogue's
    ε_out ε_inᵀ and ε_out scalings; against noisy_linear_bwd_plain and
    jax.vjp of the JAX package's noisy_linear (with its ReLU)."""
    rng = np.random.default_rng(50 + mode)
    for b, n_in, n_out in [(1024, 512, 51), (1024, 512, 306),
                           (BWD_LARGE_ROWS, 300, 200)]:
        plan = bwd_plan(b, n_in, n_out, mode)
        assert plan.path == "large" and max(plan.splits, plan.w_splits) > 1
        j, x, eps = _inputs(rng, b, n_in, n_out, mode)
        g = rng.standard_normal((b, n_out)).astype(np.float32)
        jparams = {k: jnp.asarray(v) for k, v in j.items()}
        y, vjp = jax.vjp(
            lambda p, xx: jax.nn.relu(jnoisy.noisy_linear(p, xx, None,
                                                          eps=eps)),
            jparams, jnp.asarray(x))
        jgrads, jdx = vjp(jnp.asarray(g))
        ty = torch.from_numpy(np.array(y))
        wm, ws = torch.from_numpy(j["w_mu"]), torch.from_numpy(j["w_sigma"])
        tx, tg = torch.from_numpy(x), torch.from_numpy(g)
        teps = None if eps is None else tuple(map(torch.from_numpy, eps))
        gm = torch.where(ty > 0, tg, torch.zeros_like(tg))
        dw = db = 0.0
        for s, e in plan.batch_chunks(b):
            dw = dw + gm[s:e].T @ tx[s:e]
            db = db + gm[s:e].sum(dim=0)
        weff = wm if teps is None else (
            wm + ws * (teps[1][:, None] * teps[0][None, :]))
        dx = 0.0
        for s, e in plan.chunks(n_out):
            dx = dx + gm[:, s:e] @ weff[s:e]
        if teps is None:
            got = (dx, dw, torch.zeros_like(ws), db, torch.zeros_like(db))
        else:
            got = (dx, dw, dw * (teps[1][:, None] * teps[0][None, :]), db,
                   teps[1] * db)
        plain = noisy_linear_bwd_plain(wm, ws, tx, tg, teps, ty)
        want = (jdx, jgrads["w_mu"], jgrads["w_sigma"], jgrads["b_mu"],
                jgrads["b_sigma"])
        # float32 sums of up to 1,024 O(1) terms in other orders: the
        # module's 1e-5, relative to the grads' scale.
        for a, c, w in zip(got, plain, want):
            scale = max(1.0, float(c.abs().max()))
            torch.testing.assert_close(a, c, atol=1e-5 * scale, rtol=1e-5)
            torch.testing.assert_close(a, torch.from_numpy(np.array(w)),
                                       atol=1e-5 * scale, rtol=1e-5)


# ------------------------------------- the IMPALA ResNet x4 net's fc_h ----

IMPALA_IN = 15_488  # 128 channels x 11 x 11
# Each (rows, noise mode) with which the impala-x4-bf16-b1024 cell calls
# KA's bf16 forward at fc_h (15,488 -> 512): the learner's online and
# double-Q forwards (1,024, shared), the actor (1,024, per row), the
# round's target forward (8,192, per row), the validation chunks (250, mu)
# and an evaluation's 10 envs (mu); and (path, tile, chunk, splits,
# blocks) of its plan.
IMPALA_FWD = {(1024, 1): ("large", 128, 3872, 4, 128),
              (1024, 2): ("large", 128, 3872, 4, 128),
              (8192, 2): ("large", 128, IMPALA_IN, 1, 256),
              (250, 0): ("small", 32, 5168, 3, 192),
              (10, 0): ("small", 16, 912, 17, 136)}


def test_plans_at_the_impala_cells_shapes():
    """At n_in 15,488 the existing plans cut the inputs in whole KT steps,
    the small path into a wave or more, the large one into whole waves;
    the bf16 small path takes chunks past CHUNK_MAX (it streams
    x through its ring); the learner's bf16 backward (1,024 rows, shared
    noise) keeps the small path, unsplit, 32 x 242 dx tiles. The layers
    after fc_h are the canonical net's."""
    bf16 = torch.bfloat16
    for (b, mode), want in IMPALA_FWD.items():
        p = fwd_plan(b, IMPALA_IN, 512, mode, bf16)
        assert (p.path, p.tile, p.chunk, p.splits, p.blocks) == want, (b, mode)
        _tiles_once(p.chunks(IMPALA_IN), IMPALA_IN, p.splits)
        # the small path fills a wave; the large one splits in whole waves
        assert (p.blocks >= WAVE if p.path == "small"
                else p.blocks <= WAVE or p.splits == 1)
        planes = 2 if mode else 1
        assert p.scratch == (planes * p.splits * b * 512
                             if p.splits > 1 else 0)
        assert fwd_plan(b, IMPALA_IN, 512, mode, bf16) == p
    assert IMPALA_FWD[250, 0][2] > CHUNK_MAX
    bwd = bwd_plan(1024, IMPALA_IN, 512, 1, bf16)
    assert (bwd.path, bwd.tile, bwd.chunk, bwd.splits, bwd.blocks,
            bwd.scratch) == ("small", 32, 512, 1, 32 * 242, 0)
    _tiles_once(bwd.chunks(512), 512, bwd.splits)
    # The same net in float32 would take the large backward, unsplit.
    f32 = bwd_plan(1024, IMPALA_IN, 512, 1)
    assert (f32.path, f32.splits, f32.w_splits, f32.blocks) == (
        "large", 1, 1, 4 * 121 + 8 * 121)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bf16_split_at_the_impala_fc_h_matches_plain(mode):
    """The chunks of the cell's split plans at n_in 15,488 (4 of 3,872 for
    the learner and the actor, 3 of 5,168 for validation), their partial
    sums added in chunk order, match noisy_linear_plain in bf16 on a few
    rows and outputs."""
    rng = np.random.default_rng(40 + mode)
    rows = {0: 250, 1: 1024, 2: 1024}[mode]
    plan = fwd_plan(rows, IMPALA_IN, 512, mode, torch.bfloat16)
    assert plan.splits > 1
    j, x, eps = _inputs(rng, 4, IMPALA_IN, 24, mode)
    w = {"weight_mu": j["w_mu"], "weight_sigma": j["w_sigma"],
         "bias_mu": j["b_mu"], "bias_sigma": j["b_sigma"]}
    w = {k: torch.from_numpy(v) for k, v in w.items()}
    teps = None if eps is None else tuple(map(torch.from_numpy, eps))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = _bf16_split_fwd(w, xb, teps, plan).float()
    plain = noisy_linear_plain(w, xb, teps).float()
    torch.testing.assert_close(got, plain, atol=6e-2, rtol=3e-2)
