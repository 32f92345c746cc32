"""The port's network (rainbow_tpu_torch.models, ops.head, convert) against
the JAX package's, on the CPU: the same params and inputs, made with numpy
from a seed, and the same noise, drawn by JAX and handed to both.

Tolerances: float32 on both sides differs only in the order of sums
(matmul and conv), so outputs agree to 1e-5 absolute and relative. bfloat16
rounds at other points in the two frameworks; outputs of order 1 agree to a
few bf16 ulps (2^-8 relative), so 3e-2, and the float32 softmax over those
logits to 2e-3 in probability.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rainbow_tpu
import rainbow_tpu.agent  # noqa: F401  (make_optimizer)
from rainbow_tpu.models import dqn as jdqn
from rainbow_tpu.models import noisy as jnoisy
from rainbow_tpu.ops.c51 import support_vector as jsupport

import rainbow_tpu_torch
from rainbow_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                       params_to_jax)
from rainbow_tpu_torch.models import dqn as tdqn
from rainbow_tpu_torch.models import noisy as tnoisy
from rainbow_tpu_torch.ops.c51 import support_vector as tsupport
from rainbow_tpu_torch.ops.head import dueling_head

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
A = 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(rng, n_in, n_out):
    """One noisy layer's params in both packages' names."""
    j = {"w_mu": rng.uniform(-0.2, 0.2, (n_out, n_in)),
         "w_sigma": rng.uniform(0.0, 0.1, (n_out, n_in)),
         "b_mu": rng.uniform(-0.2, 0.2, n_out),
         "b_sigma": rng.uniform(0.0, 0.1, n_out)}
    j = {k: np.asarray(v, np.float32) for k, v in j.items()}
    names = {"w_mu": "weight_mu", "w_sigma": "weight_sigma",
             "b_mu": "bias_mu", "b_sigma": "bias_sigma"}
    return ({k: jnp.asarray(v) for k, v in j.items()},
            {names[k]: torch.from_numpy(v) for k, v in j.items()})


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("mode", ["mu", "shared", "row", "injected"])
def test_noisy_linear_matches_jax(mode, relu):
    rng = np.random.default_rng(0)
    b, n_in, n_out = 5, 48, 24
    jp, tp = _layer(rng, n_in, n_out)
    x = rng.normal(size=(b, n_in)).astype(np.float32)
    key = jax.random.key(3)
    if mode == "mu":
        want = jnoisy.noisy_linear(jp, jnp.asarray(x), None)
        eps = None
    elif mode == "injected":
        e = (rng.normal(size=(b, n_in)).astype(np.float32),
             rng.normal(size=n_out).astype(np.float32))
        want = jnoisy.noisy_linear(jp, jnp.asarray(x), None,
                                   eps=tuple(map(jnp.asarray, e)))
        eps = tuple(map(_t, e))
    else:
        # JAX draws from the key; the port gets exactly those draws.
        per = mode == "row"
        want = jnoisy.noisy_linear(jp, jnp.asarray(x), key, per_sample=per)
        k_in, k_out = jax.random.split(key)
        lead = (b,) if per else ()
        eps = (_t(jnoisy._scale_noise(k_in, lead + (n_in,), jnp.float32)),
               _t(jnoisy._scale_noise(k_out, lead + (n_out,), jnp.float32)))
    if relu:
        want = jax.nn.relu(want)
    got = tnoisy.noisy_linear(tp, torch.from_numpy(x), eps, relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_noisy_linear_bf16_matches_jax():
    rng = np.random.default_rng(1)
    jp, tp = _layer(rng, 64, 32)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    e = (rng.normal(size=(6, 64)).astype(np.float32),
         rng.normal(size=(6, 32)).astype(np.float32))
    want = jnoisy.noisy_linear(jp, jnp.asarray(x, jnp.bfloat16), None,
                               eps=tuple(map(jnp.asarray, e)))
    got = tnoisy.noisy_linear(tp, torch.from_numpy(x).bfloat16(),
                              tuple(map(_t, e)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_init_and_scale_noise_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    p = tnoisy.init_noisy_params(g, 36, 10, 0.5)
    assert p["weight_mu"].shape == (10, 36) and p["bias_mu"].shape == (10,)
    assert float(p["weight_mu"].abs().max()) <= 1 / 6
    assert torch.allclose(p["weight_sigma"], torch.tensor(0.5 / 6))
    assert torch.allclose(p["bias_sigma"], torch.tensor(0.5 / 10 ** 0.5))
    n = tnoisy.scale_noise(tnoisy.NoiseStream(0), (1000,), "cpu")
    # f(x) = sign(x)·√|x| of a standard normal: E|f| = E|x|^½ ≈ 0.822.
    assert abs(float(n.abs().mean()) - 0.822) < 0.05
    # A noise stream gives the same draws again from the same seed.
    assert torch.equal(tnoisy.scale_noise(tnoisy.NoiseStream(5), 7, "cpu"),
                       tnoisy.scale_noise(tnoisy.NoiseStream(5), 7, "cpu"))


def _net(cfg, seed=0):
    jp = jdqn.init_dqn_params(jax.random.key(seed), cfg, A)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _states(rng, b, h=4):
    return rng.integers(0, 256, (b, 84, 84, h)).astype(np.float32) / 255.0


def _jax_noise(cfg, key, b):
    """JAX's per-row draws for key, as act makes them, for both packages."""
    jn = jdqn.draw_noise(cfg, A, key, lead=(b,))
    return jn, {k: (_t(a), _t(e)) for k, (a, e) in jn.items()}


@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("noise", [False, True])
def test_apply_dqn_matches_jax(log, noise):
    cfg = rainbow_tpu.data_efficient(hidden_size=32)
    jp, tp = _net(cfg)
    rng = np.random.default_rng(2)
    x = _states(rng, 3)
    key = jax.random.key(7)
    jn, tn = _jax_noise(cfg, key, 3) if noise else (None, None)
    # With a key and per-row noise JAX draws exactly draw_noise's values.
    want = jdqn.apply_dqn(jp, cfg, A, jnp.asarray(x), key if noise else None,
                          log=log, per_sample_noise=noise)
    got = tdqn.apply_dqn(tp, cfg, A, torch.from_numpy(x), log=log,
                         noise_eps=tn)
    assert got.shape == (3, A, cfg.atoms) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_apply_dqn_bf16_matches_jax():
    cfg = rainbow_tpu.data_efficient(hidden_size=32, compute_dtype="bfloat16")
    jp, tp = _net(cfg, seed=1)
    x = _states(np.random.default_rng(3), 4)
    want = jdqn.apply_dqn(jp, cfg, A, jnp.asarray(x))
    got = tdqn.apply_dqn(tp, cfg, A, torch.from_numpy(x))
    assert got.dtype == torch.float32  # the softmax stays float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_canonical_forward_flatten_order():
    """The canonical torso's 3136 features flatten channel-major (NCHW), as
    dqn.py:77-80 does; a wrong order changes every output."""
    cfg = rainbow_tpu.canonical(hidden_size=32)
    jp, tp = _net(cfg, seed=2)
    x = _states(np.random.default_rng(4), 2)
    want = jdqn.apply_dqn(jp, cfg, A, jnp.asarray(x), log=True)
    got = tdqn.apply_dqn(tp, cfg, A, torch.from_numpy(x), log=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    feat_j = jdqn._torso(jp, cfg, jnp.asarray(x))
    feat_t = tdqn.torso(tp, cfg, torch.from_numpy(x))
    assert feat_t.shape == (2, 3136)
    np.testing.assert_allclose(feat_t.numpy(), np.asarray(feat_j), **F32)


def test_q_values_and_head_match_jax():
    cfg = rainbow_tpu.data_efficient(hidden_size=32)
    jp, tp = _net(cfg, seed=3)
    x = _states(np.random.default_rng(5), 6)
    js = jsupport(cfg.v_min, cfg.v_max, cfg.atoms)
    want = np.asarray(jdqn.q_values(jp, cfg, A, js, jnp.asarray(x)))
    ts = tsupport(cfg.v_min, cfg.v_max, cfg.atoms, "cpu")
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    got = tdqn.q_values(tp, cfg, A, ts, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    head = tdqn.forward_head(tp, cfg, A, torch.from_numpy(x))
    np.testing.assert_allclose(head.q.numpy(), want, **F32)
    np.testing.assert_allclose(head.max_q.numpy(), want.max(1), **F32)
    np.testing.assert_array_equal(head.action.numpy(), want.argmax(1))
    assert head.dist is None


def test_dueling_head_first_max_wins_and_modes():
    z = tsupport(-10.0, 10.0, 51, "cpu")
    v = torch.zeros(2, 51)
    a = torch.zeros(2, 3 * 51)  # every action ties: jnp.argmax picks 0
    out = dueling_head(v, a, z, 3, "log")
    assert out.action.tolist() == [0, 0]
    assert out.action.dtype == torch.int64
    np.testing.assert_allclose(out.dist.exp().sum(-1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError):
        dueling_head(v, a, z, 3, "logits")


def test_params_round_trip_and_layout():
    cfg = rainbow_tpu.canonical(hidden_size=16)
    jp = jax.tree.map(np.asarray, jdqn.init_dqn_params(jax.random.key(4), cfg,
                                                       A))
    tp = params_from_jax(jp, device="cpu")
    assert tp["convs.0.weight"].shape == (32, 4, 8, 8)  # OIHW
    assert tp["convs.4.weight"].shape == (64, 64, 3, 3)
    assert tp["fc_h_v.weight_mu"].shape == (16, 3136)
    assert tp["fc_z_a.bias_sigma"].shape == (A * 51,)
    back = params_to_jax(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(x, y)


def test_init_dqn_params_keys_and_device():
    cfg = rainbow_tpu_torch.data_efficient(hidden_size=8)
    tp = tdqn.init_dqn_params(cfg, A, 0, "cpu")
    jp = params_from_jax(jax.tree.map(
        np.asarray, jdqn.init_dqn_params(jax.random.key(0), cfg, A)),
        device="cpu")
    assert {k: v.shape for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdqn.init_dqn_params(cfg, A, 0, "cuda")


@pytest.mark.parametrize("seed", [0, 7, 3, 42, 2 ** 31, 2 ** 33 + 5, -1])
def test_threefry_keys_and_uniforms_match_jax(seed):
    """utils.threefry against jax.random on its default (partitionable)
    Threefry: key, split into 2 and 5 keys, and uniforms of odd and large
    shapes over the bounds the init uses, bit for bit."""
    from rainbow_tpu_torch.utils import threefry

    k = jax.random.key(seed)
    assert tuple(np.asarray(jax.random.key_data(k))) == threefry.key(seed)
    for n in (2, 5):
        want = np.asarray(jax.random.key_data(jax.random.split(k, n)))
        assert np.array_equal(np.array(threefry.split(threefry.key(seed), n)),
                              want)
    for shape, bound in (((7,), 0.3), ((32, 4, 5, 5), 0.1),
                         ((256, 576), 1 / 24)):
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, -bound,
                                             bound))
        got = threefry.uniform(threefry.key(seed), shape, -bound, bound)
        assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("preset,n_act,seed", [
    ("canonical", 6, 0), ("canonical", 18, 123), ("data_efficient", 4, 7),
    ("data_efficient", 4, 3), ("data_efficient", 4, 42)])
def test_seeded_params_are_the_jax_trainers(preset, n_act, seed):
    """The port's init_agent starts from the params the JAX package's
    Trainer starts from for the same seed (its agent key: the first of
    split(key(seed)), rainbow_tpu/train.py:532-534), bit for bit."""
    from rainbow_tpu import agent as jag
    from rainbow_tpu_torch import agent as tag

    jcfg = getattr(rainbow_tpu, preset)(hidden_size=32)
    tcfg = getattr(rainbow_tpu_torch, preset)(hidden_size=32)
    k_agent = jax.random.split(jax.random.key(seed))[0]
    want = params_from_jax(jax.tree.map(
        np.asarray, jag.init_agent(k_agent, jcfg, n_act).params),
        device="cpu")
    got = tag.init_agent(tcfg, n_act, seed, "cpu")
    assert list(got.params) == list(want)
    for k, v in want.items():
        assert torch.equal(got.params[k], v), k
        assert torch.equal(got.target_params[k], v), k


def test_params_and_support_default_to_the_card():
    """params_from_jax, opt_state_from_jax and support_vector put their
    tensors on the card unless asked for the CPU, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    cfg = rainbow_tpu.data_efficient(hidden_size=8)
    jp = jax.tree.map(np.asarray,
                      jdqn.init_dqn_params(jax.random.key(0), cfg, A))
    opt = jax.tree.map(np.asarray, rainbow_tpu.agent.make_optimizer(cfg)
                       .init(jp))
    for call in (lambda: params_from_jax(jp),
                 lambda: opt_state_from_jax(opt),
                 lambda: tsupport(-10.0, 10.0, 51)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert params_from_jax(jp, device="cpu")["fc_z_v.bias_mu"].device.type \
        == "cpu"
    assert opt_state_from_jax(opt, device="cpu").count.device.type == "cpu"


def test_port_imports_nothing_of_jax():
    """The port and chip_smoke.py import torch and numpy, never JAX, Flax,
    Optax or the JAX package."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "rainbow_tpu_torch").rglob("*.py"))
    port = root / "rainbow_tpu_torch"
    for module in ("parallel/learner.py", "parallel/mesh.py",
                   "parallel/multihost.py", "utils/torch_import.py"):
        assert port / module in files, module
    files.append(root / "chip_smoke.py")
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|rainbow_tpu)(\.|\s|$)", re.M)
    for f in files:
        hits = banned.findall(f.read_text())
        assert not hits, f"{f.relative_to(root)} imports {hits}"
