"""The port's IMPALA ResNet x4 torso (``--architecture impala-x4``) on the
CPU: its shapes, key order and draws; its forward, the learner's loss and
every gradient against a plain PyTorch network written from the papers
(tests/impala_plain.py, which imports nothing of the port); its layout:
channels-last in every dtype from the input through every convolution,
pool, ReLU, add and gradient, the forwards counted by the layout their
input came in, the features and bfloat16 gradients those of the plain
network computed NCHW, the gradients that reach Adam contiguous and OIHW;
the two conv
stacks, bit for bit what they were before the torso became one forward per
architecture; the CLI, a CPU Trainer, a checkpoint of its 46 tensors, and
both importers, which have no source for it; and the benchmark's torso
file (port_bench/reference/torsos/impala-x4.py), bit for bit the plain
network's.

Tolerances: float32 on both sides runs the same convolutions and products
in the same dtype, so the streams and the loss agree to 1e-5 and each
gradient tensor to 1e-4 of its largest element (sums in another order). In
bfloat16 both sides round at the same points (the operands cast to
bfloat16, float32 sums inside each product, the softmax in float32): the
streams agree to a few bfloat16 ulps of O(1) values (3e-2, as the port's
other bfloat16 tests), and each gradient tensor to 2e-2 of its norm.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

import impala_plain as plain
import rainbow_tpu_torch
from rainbow_tpu_torch import checkpoint as ckpt
from rainbow_tpu_torch import cli
from rainbow_tpu_torch import convert
from rainbow_tpu_torch.models import dqn
from rainbow_tpu_torch.ops.c51 import head_loss
from rainbow_tpu_torch.utils import threefry
from rainbow_tpu_torch.utils import torch_import as tim

ROOT = Path(__file__).resolve().parents[1]
A, HIDDEN, ATOMS = 6, 32, 51
FLAT = 128 * 11 * 11


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the CPU's convolution sums do not depend on
    them here, and several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch="impala-x4", dtype="float32", **kw):
    return rainbow_tpu_torch.canonical(architecture=arch, hidden_size=HIDDEN,
                                       compute_dtype=dtype, **kw)


def _plain_params(seed=0):
    return plain.init_params(torch.Generator().manual_seed(seed), 4, 84,
                             HIDDEN, ATOMS, A)


def _inputs(cfg, b, seed=1):
    """Frames, shared noise of every noisy layer, taken actions, target
    distributions and IS weights, from a seed."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((b, 84, 84, 4), generator=g)
    dims = dqn._noisy_dims(cfg, A)
    eps = {k: (torch.randn(din, generator=g), torch.randn(dout, generator=g))
           for k, (din, dout) in dims.items()}
    actions = torch.randint(0, A, (b,), generator=g)
    m = torch.softmax(torch.randn((b, ATOMS), generator=g), 1)
    w = torch.rand((b,), generator=g) + 0.5
    return x, eps, actions, m, w


# ------------------------------------------------------------ the torso --

def test_torso_shapes_key_order_and_flat():
    cfg = _cfg()
    shapes = dqn.param_shapes(cfg, A)
    assert len(shapes) == 46
    names = list(shapes)
    assert names[:6] == ["torso.0.conv.weight", "torso.0.conv.bias",
                         "torso.0.0.conv1.weight", "torso.0.0.conv1.bias",
                         "torso.0.0.conv2.weight", "torso.0.0.conv2.bias"]
    assert names[28:30] == ["torso.2.1.conv2.weight", "torso.2.1.conv2.bias"]
    assert names[30:] == [f"{n}.{k}" for n in dqn.NOISY_LAYERS
                          for k in dqn.NOISY_KEYS]
    assert shapes["torso.0.conv.weight"] == (64, 4, 3, 3)
    assert shapes["torso.1.conv.weight"] == (128, 64, 3, 3)
    assert shapes["torso.2.0.conv1.weight"] == (128, 128, 3, 3)
    assert cfg.conv_output_size == FLAT == plain.flat(84) == 15_488
    assert shapes["fc_h_v.weight_mu"] == (HIDDEN, FLAT)
    assert shapes == plain.param_shapes(4, 84, HIDDEN, ATOMS, A)
    torso_params = sum(math.prod(s) for k, s in shapes.items()
                       if k.startswith("torso."))
    assert torso_params == 1_552_192
    full = dqn.param_shapes(rainbow_tpu_torch.canonical(
        architecture="impala-x4"), A)
    assert sum(math.prod(s) for s in full.values()) == 33_639_946
    p = dqn.init_dqn_params(cfg, A, 0, "cpu")
    feat = dqn.torso(p, cfg, torch.rand(2, 84, 84, 4))
    assert feat.shape == (2, FLAT)


def test_init_draws_one_threefry_key_per_convolution_in_order():
    """The JAX Trainer's key path (agent key, params key), then one key per
    convolution in param_shapes' order and one per noisy layer; each
    convolution's weight (drawn HWIO) and bias U(±1/√(9·cin))."""
    cfg = _cfg()
    p = dqn.init_dqn_params(cfg, A, 5, "cpu")
    assert list(p) == list(dqn.param_shapes(cfg, A))
    k_params = threefry.split(threefry.split(threefry.key(5), 2)[0], 3)[0]
    keys = threefry.split(k_params, 15 + 4)
    for i, (name, cin) in enumerate([("torso.0.conv", 4),
                                     ("torso.0.0.conv1", 64),
                                     ("torso.1.conv", 64),
                                     ("torso.2.1.conv2", 128)]):
        at = [c[0] for c in dqn.torso_of("impala-x4").convs(4)].index(name)
        k_w, k_b = threefry.split(keys[at], 2)
        cout = p[f"{name}.weight"].shape[0]
        bound = 1.0 / (9 * cin) ** 0.5
        w = threefry.uniform(k_w, (3, 3, cin, cout), -bound, bound)
        assert np.array_equal(p[f"{name}.weight"].numpy(),
                              w.transpose(3, 2, 0, 1)), name
        assert np.array_equal(p[f"{name}.bias"].numpy(), threefry.uniform(
            k_b, (cout,), -bound, bound)), name
        assert float(p[f"{name}.weight"].abs().max()) <= bound
    k_w, _ = threefry.split(keys[15], 2)
    mu = 1.0 / np.sqrt(np.float32(FLAT))
    assert np.array_equal(p["fc_h_v.weight_mu"].numpy(), threefry.uniform(
        k_w, (HIDDEN, FLAT), -mu, mu))


def _port_loss(params, cfg, x, eps, actions, m, w):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    v, a = dqn.loss_streams(leaves, cfg, A, x, eps)
    per, loss = head_loss(v, a, actions, m, w)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (v.detach(), a.detach()), per, loss.detach(), dict(
        zip(leaves, grads))


def _plain_loss(params, dtype, x, eps, actions, m, w):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    v, a = plain.streams(leaves, x, eps, dtype)
    per, loss = plain.loss(v, a, actions, m, w)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (v.detach(), a.detach()), per.detach(), loss.detach(), dict(
        zip(leaves, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_gradients_match_plain(dtype):
    cfg = _cfg(dtype=dtype)
    params = _plain_params()
    x, eps, actions, m, w = _inputs(cfg, 3)
    got = _port_loss(params, cfg, x, eps, actions, m, w)
    want = _plain_loss(params, getattr(torch, dtype), x, eps, actions, m, w)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else \
        dict(atol=3e-2, rtol=3e-2)
    for g, wv in zip(got[0], want[0]):
        assert g.dtype == getattr(torch, dtype)
        torch.testing.assert_close(g.float(), wv.float(), **tol)
    torch.testing.assert_close(got[1], want[1], **tol)
    torch.testing.assert_close(got[2], want[2], **tol)
    assert list(got[3]) == list(want[3])
    for k, gk in got[3].items():
        wk = want[3][k].float()
        assert gk.dtype == torch.float32 and gk.shape == wk.shape, k
        scale = float(wk.abs().max())
        assert scale > 0, k
        if dtype == "float32":
            torch.testing.assert_close(gk, wk, atol=1e-4 * scale, rtol=0,
                                       msg=k)
        else:
            assert float((gk - wk).norm()) <= 2e-2 * float(wk.norm()), k
    # the act's forward, μ only, agrees too
    q = dqn.q_values(params, cfg, A, torch.linspace(-10, 10, ATOMS), x)
    v, a = plain.streams(params, x, None, getattr(torch, dtype))
    b = x.shape[0]
    z = (v.reshape(b, 1, ATOMS) + a.reshape(b, A, ATOMS)
         - a.reshape(b, A, ATOMS).mean(1, keepdim=True)).float()
    want_q = (torch.softmax(z, 2) * torch.linspace(-10, 10, ATOMS)).sum(2)
    torch.testing.assert_close(q, want_q, **tol)


# ------------------------------------------------ the layout: channels-last --

def _window_states(b, seed=3):
    """Frames as the learner's batches hold them: K6's frame-major windows
    (history + n-step frames of 84 x 84 a row) permuted to (B, 84, 84, H),
    so that the torso's permuted view is NCHW in memory."""
    from rainbow_tpu_torch.kernels.replay import window_fields
    g = torch.Generator().manual_seed(seed)
    win = torch.randint(0, 256, (1, b, 7, 84 * 84), generator=g,
                        dtype=torch.uint8)
    return window_fields(win, 4, 3, {})["states"][0].float() / 255


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_torso_forward_counts_its_layout(dtype):
    """Every IMPALA forward, with and without autograd, counts the layout
    its input came in: the act's NHWC frame stack "nhwc", the learner's
    frame-major batch "nchw". Both give the same channel-major (B, 15,488)
    features, those of the plain network."""
    cfg = _cfg(dtype=dtype)
    dt = getattr(torch, dtype)
    params = dqn.init_dqn_params(cfg, A, 0, "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    batch = _window_states(3).to(dt)
    stack = batch.contiguous()
    dqn.reset_torso_inputs()
    assert set(dqn.torso_inputs().values()) == {0}
    feats = []
    for x in (stack, batch):
        with torch.no_grad():
            feats.append(dqn.torso(params, cfg, x))
        feats.append(dqn.torso(leaves, cfg, x).detach())
    counts = dqn.torso_inputs()
    assert counts == {k: 2 if k in ("impala-x4.nhwc", "impala-x4.nchw")
                      else 0 for k in counts}
    want = plain.torso(params, batch.permute(0, 3, 1, 2))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else \
        dict(atol=3e-2, rtol=3e-2)
    for f in feats:
        assert f.shape == (3, FLAT) and f.dtype == dt and f.is_contiguous()
        torch.testing.assert_close(f, feats[0], atol=0, rtol=0)
        torch.testing.assert_close(f.float(), want.float(), **tol)
    dqn.reset_torso_inputs()


def _layout_log():
    """A dispatch mode that records, for each convolution, max pool, ReLU
    and add of the forward and backward, whether each of its 4-D tensors
    is channels-last ("nhwc"), contiguous ("nchw") or neither."""
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = {"convolution", "convolution_backward", "max_pool2d_with_indices",
           "max_pool2d_with_indices_backward", "relu", "threshold_backward",
           "add"}

    def form(t):
        if t.is_contiguous(memory_format=torch.channels_last):
            return "nhwc"
        return "nchw" if t.is_contiguous() else "strided"

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.rows = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ops:
                flat = list(args) + list(out if isinstance(out, tuple)
                                         else (out,))
                self.rows += [(name, form(t)) for t in flat
                              if isinstance(t, torch.Tensor) and t.dim() == 4]
            return out
    return Log()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_torso_runs_channels_last_forward_and_backward(dtype):
    """On the learner's frame-major batch, every 4-D tensor that reaches a
    convolution, a max pool, a ReLU or a residual add, forward or
    backward, and every one they return, is channels-last in every dtype:
    the input, the weights, the activations and the gradients from the
    flatten down."""
    cfg = _cfg(dtype=dtype)
    params = dqn.init_dqn_params(cfg, A, 0, "cpu")
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()
              if k.startswith("torso.")}
    x = _window_states(2).to(getattr(torch, dtype))
    with _layout_log() as log:
        f = dqn.torso(leaves, cfg, x)
        torch.autograd.grad(f.float().square().sum(), list(leaves.values()))
    seen = {name for name, _ in log.rows}
    assert seen == {"convolution", "convolution_backward",
                    "max_pool2d_with_indices",
                    "max_pool2d_with_indices_backward", "relu",
                    "threshold_backward", "add"}
    assert [r for r in log.rows if r[1] != "nhwc"] == []


def test_bf16_nhwc_gradients_match_nchw_and_plain():
    """The bfloat16 NHWC forward and its gradient of every convolution's
    weight and bias, on the learner's frame-major batch, against the plain
    network, which computes it NCHW in bfloat16 (its convolutions, pools,
    ReLUs and adds see no channels-last tensor), at
    test_forward_loss_and_gradients_match_plain's bfloat16 tolerances; the
    gradients float32, contiguous and OIHW."""
    cfg = _cfg(dtype="bfloat16")
    params = _plain_params(2)
    _x, eps, actions, m, w = _inputs(cfg, 3)
    x = _window_states(3, seed=5)
    got = _port_loss(params, cfg, x, eps, actions, m, w)
    with _layout_log() as log:
        want = _plain_loss(params, torch.bfloat16, x, eps, actions, m, w)
    assert log.rows and {r[1] for r in log.rows} == {"nchw"}
    tol = dict(atol=3e-2, rtol=3e-2)
    for g, wv in zip(got[0], want[0]):
        torch.testing.assert_close(g.float(), wv.float(), **tol)
    torch.testing.assert_close(got[2], want[2], **tol)
    for k, gk in got[3].items():
        if not k.startswith("torso."):
            continue
        wk = want[3][k].float()
        assert gk.dtype == torch.float32 and gk.is_contiguous(), k
        assert gk.shape == params[k].shape, k
        assert float((gk - wk).norm()) <= 2e-2 * float(wk.norm()), k


def test_gradients_handed_to_apply_grads_are_contiguous(monkeypatch):
    """A bfloat16 learner round of the IMPALA net on a CPU ring: every
    gradient that reaches agent.apply_grads is a float32 tensor,
    contiguous, with param_shapes' shape, and every torso forward of the
    round (its target forward, then per update the double-Q selection and
    the loss) takes the frame-major batch, NCHW."""
    from rainbow_tpu_torch import agent as ag
    from rainbow_tpu_torch import train
    from rainbow_tpu_torch.replay import prioritized as rp
    cfg = _cfg(dtype="bfloat16", adam_mu_dtype="bfloat16", batch_size=3)
    e, c = 2, 12
    g = torch.Generator().manual_seed(4)
    rep = rp.init_replay(e, c, device="cpu")
    rep.frames.copy_(torch.randint(0, 256, rep.frames.shape, generator=g,
                                   dtype=torch.uint8))
    rep.actions.copy_(torch.randint(0, A, (e, c), generator=g))
    rep.rewards.copy_(torch.randn((e, c), generator=g))
    rep.timesteps.copy_(torch.arange(c).expand(e, c))
    rep.nonterminal.fill_(True)
    rep.priorities.copy_(torch.rand((e, c), generator=g) + 0.1)
    rep.full.fill_(True)
    agent = ag.init_agent(cfg, A, 0, "cpu")
    shapes = dqn.param_shapes(cfg, A)
    seen, real = [], ag.apply_grads

    def watching(agent_, cfg_, grads):
        seen.append(grads)
        return real(agent_, cfg_, grads)
    monkeypatch.setattr(ag, "apply_grads", watching)
    dqn.reset_torso_inputs()
    loss = train.learner_round(agent, rep, cfg, A, 2, 0.4)
    assert math.isfinite(float(loss)) and len(seen) == 2
    for grads in seen:
        assert list(grads) == list(shapes)
        for k, gk in grads.items():
            assert gk.dtype == torch.float32 and gk.is_contiguous(), k
            assert tuple(gk.shape) == shapes[k], k
    counts = dqn.torso_inputs()
    assert counts["impala-x4.nchw"] == 5
    assert sum(counts.values()) == 5
    dqn.reset_torso_inputs()


# -------------------------------------------- the conv stacks, unchanged --

OLD_ARCHS = {"canonical": ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
             "data-efficient": ((32, 5, 5), (64, 5, 5))}


def old_torso(params, cfg, x):
    """models/dqn.py's torso before it became one forward per
    architecture: the table of (out channels, kernel, stride)."""
    x = x.permute(0, 3, 1, 2)
    for i, (_c, _k, stride) in enumerate(OLD_ARCHS[cfg.architecture]):
        w = params[f"convs.{2 * i}.weight"].to(x.dtype)
        b = params[f"convs.{2 * i}.bias"].to(x.dtype)
        x = F.relu(F.conv2d(x, w, b, stride=stride))
    return x.reshape(x.shape[0], -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", sorted(OLD_ARCHS))
def test_conv_stacks_are_the_pre_refactor_bits(arch, dtype):
    """Shapes, draws, the torso's features and their gradients, and the
    whole loss and its gradients, torch.equal to the table's path."""
    cfg = _cfg(arch, dtype)
    shapes = dqn.param_shapes(cfg, A)
    old_shapes, cin = {}, 4
    for i, (cout, k, _s) in enumerate(OLD_ARCHS[arch]):
        old_shapes[f"convs.{2 * i}.weight"] = (cout, cin, k, k)
        old_shapes[f"convs.{2 * i}.bias"] = (cout,)
        cin = cout
    assert list(shapes.items())[:len(old_shapes)] == list(old_shapes.items())
    assert cfg.conv_output_size == {"canonical": 3136,
                                    "data-efficient": 576}[arch]
    params = dqn.init_dqn_params(cfg, A, 3, "cpu")
    x = torch.rand((3, 84, 84, 4), generator=torch.Generator().manual_seed(2))
    x = x.to(dqn._compute_dtype(cfg))
    feats, grads = [], []
    for fn in (dqn.torso, old_torso):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()
                  if k.startswith("convs.")}
        f = fn(leaves, cfg, x)
        feats.append(f.detach())
        grads.append(torch.autograd.grad(f.float().square().sum(),
                                         list(leaves.values())))
    assert torch.equal(*feats)
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    # the whole loss through loss_streams, with the old torso in its place
    _x, eps, actions, m, w = _inputs(cfg, 3)
    got = _port_loss(params, cfg, _x, eps, actions, m, w)
    real = dqn.torso
    try:
        dqn.torso = old_torso
        want = _port_loss(params, cfg, _x, eps, actions, m, w)
    finally:
        dqn.torso = real
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert torch.equal(got[2], want[2])
    assert all(torch.equal(got[3][k], want[3][k]) for k in got[3])


def test_torso_is_looked_up_at_call_time_and_is_a_profiler_range(tmp_path):
    """Every forward calls models.dqn.torso by its module name (so that a
    wrapper put there sees each call and its rows), and under a profiler
    each call is the range rainbow.torso."""
    cfg = _cfg()
    params = dqn.init_dqn_params(cfg, A, 0, "cpu")
    x = torch.rand(2, 84, 84, 4)
    calls, real = [], dqn.torso

    def counting(p, c, xx):
        calls.append((c.architecture, xx.shape[0], xx.dtype,
                      torch.is_grad_enabled()))
        return real(p, c, xx)

    dqn.torso = counting
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dqn.apply_dqn(params, cfg, A, x)
            with torch.no_grad():
                dqn.q_values(params, cfg, A, torch.linspace(-10, 10, ATOMS),
                             x[:1])
    finally:
        dqn.torso = real
    assert calls == [("impala-x4", 2, torch.float32, True),
                     ("impala-x4", 1, torch.float32, False)]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    import json
    with open(path) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X"]
    assert names.count("rainbow.torso") == 2


# ------------------------------------------------- CLI, Trainer, files --

TINY = ["--num-envs", "4", "--memory-capacity", "128", "--batch-size", "4",
        "--learn-start", "64", "--replay-frequency", "4", "--target-update",
        "64", "--evaluation-interval", "68", "--evaluation-episodes", "1",
        "--evaluation-size", "4", "--hidden-size", "32", "--multi-step", "3",
        "--env-backend", "fake", "--max-episode-length", "40",
        "--architecture", "impala-x4", "--T-max", "68"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_trains_impala_through_the_trainer(dtype, tmp_path, monkeypatch):
    """--architecture impala-x4 parses, and two learning iterations of the
    CPU Trainer (T = 64, learn start, and 68, with an evaluation) finish
    with a finite loss and moved params."""
    monkeypatch.chdir(tmp_path)
    argv = TINY + ["--compute-dtype", dtype, "--adam-mu-dtype", dtype,
                   "--id", "impala"]
    cfg, _ = cli.parse_config(argv)
    assert cfg.architecture == "impala-x4" and cfg.compute_dtype == dtype
    before = dqn.init_dqn_params(cfg, 6, cfg.seed, "cpu")
    tr = cli.main(argv, device="cpu")
    assert tr.T == 68 and tr.agent.step == 2
    assert math.isfinite(float(tr._last_loss))
    assert len(tr.agent.params) == 46
    moved = [k for k, v in tr.agent.params.items()
             if not torch.equal(v, before[k])]
    assert "torso.0.conv.weight" in moved and "fc_h_v.weight_mu" in moved
    assert tr.metrics["steps"], tr.metrics


def test_checkpoint_of_the_46_tensors_round_trips(tmp_path):
    cfg = _cfg()
    params = dqn.init_dqn_params(cfg, A, 9, "cpu")
    path = str(tmp_path / "model.npz")
    ckpt.save_params(path, params)
    back = ckpt.load_params(path, "cpu")
    assert list(back) == list(params) and len(back) == 46
    assert all(torch.equal(back[k], params[k]) for k in params)


def test_both_importers_refuse_impala(tmp_path):
    """Neither Kaixhin/Rainbow nor the JAX package has this torso: the
    JAX-checkpoint import, the JAX conversion and the state-dict import
    each raise, naming it."""
    cfg = _cfg()
    params = dqn.init_dqn_params(cfg, A, 0, "cpu")
    with pytest.raises(ValueError, match="impala-x4"):
        tim.jax_leaf_order(cfg, A)
    path = str(tmp_path / "model.npz")
    np.savez(path, arr_0=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="impala-x4"):
        tim.load_jax_params(path, cfg, A, "cpu")
    with pytest.raises(ValueError, match="impala-x4"):
        convert.params_to_jax(params)
    with pytest.raises(ValueError, match="impala-x4"):
        tim.convert_state_dict({k: v.numpy() for k, v in params.items()})
    # the conv stacks still convert both ways
    stack = dqn.init_dqn_params(_cfg("canonical"), A, 0, "cpu")
    assert set(tim.convert_state_dict(stack)) == set(stack)
    assert len(convert.params_to_jax(stack)["convs"]) == 3


# ------------------------------------------------ the benchmark's copy --

def _bench_torso():
    import sys
    sys.path.insert(0, str(ROOT))
    path = ROOT / "port_bench" / "reference" / "torsos" / "impala-x4.py"
    spec = importlib.util.spec_from_file_location("bench_impala_x4", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_network_and_the_benchmarks_torso_file_agree(dtype):
    """The same shapes in the same order, the same U(±b) bounds, the same
    features bit for bit, and the multiply-adds the benchmark counts:
    802,934,784 a frame at history 4, frame 84."""
    from port_bench.reference.rainbow import Precision
    bench = _bench_torso()
    torso_shapes = {k: v for k, v in plain.param_shapes(
        4, 84, HIDDEN, ATOMS, A).items() if k.startswith("torso.")}
    assert list(bench.param_shapes(4).items()) == list(torso_shapes.items())
    assert bench.init_bounds(4) == {
        k: 1 / math.sqrt(9 * torso_shapes[k.rsplit(".", 1)[0] + ".weight"][1])
        for k in torso_shapes}
    assert bench.flat(4, 84) == plain.flat(84) == FLAT
    assert bench.macs(4, 84) == 802_934_784
    dt = getattr(torch, dtype)
    p = _plain_params(4)
    x = torch.rand((2, 4, 84, 84), generator=torch.Generator().manual_seed(8))
    x = x.to(dt)
    assert torch.equal(bench.forward(p, x, Precision(dt)), plain.torso(p, x))


def test_the_benchmarks_torso_roofline_reads_the_tallied_forwards():
    """port_bench/metrics/roofline_pct.torso.py: its tally key at the
    port's torso (architecture, rows, dtype, whether autograd records the
    call), and its reading: 2·macs·rows operations a forward, three times
    that for a recorded one, at the dtype's peak, over the device time of
    the kernels its pattern names (cuDNN's, the layout conversions, the max
    pools), none where it finds nothing."""
    import sys
    from types import SimpleNamespace
    sys.path.insert(0, str(ROOT))
    path = ROOT / "port_bench" / "metrics" / "roofline_pct.torso.py"
    spec = importlib.util.spec_from_file_location("torso_roofline", path)
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    (module, name, key), = metric.TALLY
    assert (module, name) == ("rainbow_tpu_torch.models.dqn", "torso")
    cfg = _cfg(dtype="bfloat16")
    params = dqn.init_dqn_params(cfg, A, 0, "cpu")
    x = torch.rand(2, 84, 84, 4).to(torch.bfloat16)
    assert key(params, cfg, x) == ("impala-x4", 2, "bfloat16", False)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    assert key(leaves, cfg, x) == ("impala-x4", 2, "bfloat16", True)
    with torch.no_grad():
        assert key(leaves, cfg, x)[3] is False
    macs = 802_934_784
    ops = [("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
             0.0, 0.25),
           ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16", 0.0, 0.1),
           ("void cudnn::engines_precompiled::nchwToNhwcKernel<bf16>", 0.0,
            0.05),
           ("void at::native::max_pool_backward_nchw<bf16>", 0.0, 0.1),
           ("void at::native::elementwise_kernel<CUDAFunctor_add<bf16>>",
            0.0, 1.0),
           ("noisy_linear_fwd_mma<1, 128, 128, 2>", 0.0, 1.0)]
    run = SimpleNamespace(
        hyper=SimpleNamespace(history=4, frame=84),
        trace={"ops": ops},
        tallies={"roofline_pct.torso": {
            ("impala-x4", 1024, "bfloat16", True): 8,
            ("impala-x4", 8192, "bfloat16", False): 1}})
    flops = 8 * 3 * 2 * macs * 1024 + 2 * macs * 8192
    assert metric.read(run) == pytest.approx(
        100 * flops / 989e12 / 0.5, rel=1e-12)
    assert metric.read(SimpleNamespace(hyper=run.hyper, trace=run.trace,
                                       tallies={})) is None
    run.trace = {"ops": ops[4:]}
    assert metric.read(run) is None


def _chip_smoke():
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_holds_ka_and_k9_to_the_impala_cell():
    """chip_smoke.py runs the card tests (tests/test_torch_port_cuda.py) as
    a phase of its own, and they take their cases from card_cases: each of
    BENCHMARK.json's cells built from its files as cli.main does
    (bench_cells), in order, and KA's calls in each (noisy_layer_batches,
    ka_calls): the IMPALA cell's in bfloat16 only, KA's forward at the
    act's 1,024 rows (per-row noise), validation's 250 (mu), the learner's
    1,024 (shared) and the round's 8,192 (per-row), its backward at the
    learner's 1,024, all at 15,488 features; K9 over its net's 46
    tensors."""
    import inspect
    import json

    import card_cases

    smoke = _chip_smoke()
    assert "test_torch_port_cuda.py" in inspect.getsource(
        smoke.run_card_tests)
    assert "run_card_tests(torch)" in inspect.getsource(smoke.main)
    with open(ROOT / "BENCHMARK.json") as f:
        names = [w["name"] for w in json.load(f)["workloads"]]
    cells = card_cases.bench_cells()
    assert [name for name, _ in cells] == names
    c = dict(cells)["impala-x4-bf16-b1024"]
    assert (c.architecture, c.compute_dtype, c.adam_mu_dtype) == (
        "impala-x4", "bfloat16", "bfloat16")
    fwd = {(b, i): m for b, m, i, _o, _r in
           card_cases.noisy_layer_batches([c], A, fwd=True)}
    calls = ((1024, "row"), (250, "mu"), (1024, "shared"), (8192, "row"))
    for rows, mode in calls:
        assert mode in fwd[(rows, FLAT)], (rows, mode)
    bwd = {(b, i): m for b, m, i, _o, _r in
           card_cases.noisy_layer_batches([c], A, fwd=False)}
    assert "shared" in bwd[(1024, FLAT)]
    cfgs = card_cases.configs()
    ka_fwd = card_cases.ka_calls(cfgs, cells, True)
    ka_bwd = card_cases.ka_calls(cfgs, cells, False)
    for rows, mode in calls:
        assert ((rows, FLAT, 512), mode, "bfloat16") in ka_fwd
    assert ((1024, FLAT, 512), "shared", "bfloat16") in ka_bwd
    assert not any(shape[1] == FLAT and dtype == "float32"
                   for shape, _, dtype in ka_fwd + ka_bwd)
    assert len(card_cases.param_shapes(c, A)) == 46
    nets = card_cases.adam_nets(cfgs, cells)
    assert len(nets["impala-x4-bf16-b1024"]) == 46


def test_chip_smoke_holds_the_nhwc_cell_update_and_counts_forwards():
    """Of BENCHMARK.json's cells, the IMPALA cell alone has the torso that
    runs NHWC, so the card tests' NHWC update case (no layout conversion,
    KA on the torso's features, K9 on its gradients), which chip_smoke.py
    runs, is selected for it alone, beside the float32 Nature net's;
    chip_smoke.py's count of torso forwards gives those of the
    configuration's torso by the layout their input came in, and fails on
    another torso's or on none."""
    import card_cases

    smoke = _chip_smoke()
    cells = card_cases.bench_cells()
    nhwc = [name for name, c in cells
            if isinstance(dqn.torso_of(c.architecture), dqn.ImpalaResNet)]
    assert nhwc == ["impala-x4-bf16-b1024"]
    layouts = card_cases.layout_cases(cells)
    assert list(layouts) == ["canonical-float32", "impala-x4-bf16-b1024"]
    assert layouts["canonical-float32"].architecture == "canonical"
    assert layouts["impala-x4-bf16-b1024"].compute_dtype == "bfloat16"
    cfg = _cfg(dtype="bfloat16")
    params = dqn.init_dqn_params(cfg, A, 0, "cpu")
    dqn.reset_torso_inputs()
    with pytest.raises(smoke.Failed):
        smoke.torso_input_counts(torch, cfg, "t")
    with torch.no_grad():
        dqn.torso(params, cfg, torch.rand(2, 84, 84, 4).to(torch.bfloat16))
        dqn.torso(params, cfg, _window_states(2).to(torch.bfloat16))
    assert smoke.torso_input_counts(torch, cfg, "t") == {
        "impala-x4.nhwc": 1, "impala-x4.nchw": 1}
    with pytest.raises(smoke.Failed):
        smoke.torso_input_counts(torch, _cfg("canonical"), "t")
    dqn.reset_torso_inputs()
    with pytest.raises(smoke.Failed):
        smoke.torso_input_counts(torch, cfg, "t")
    with torch.no_grad():
        dqn.torso(params, cfg, torch.rand(2, 84, 84, 4).to(torch.bfloat16))
        dqn.torso(params, cfg, _window_states(2).to(torch.bfloat16))
    assert smoke.torso_input_counts(torch, cfg, "t") == {
        "impala-x4.nhwc": 1, "impala-x4.nchw": 1}
    with pytest.raises(smoke.Failed):
        smoke.torso_input_counts(torch, _cfg("canonical"), "t")
    dqn.reset_torso_inputs()
