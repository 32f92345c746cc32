"""The torso files (reference/torsos/<architecture>.py) against the code
path they replaced, a table of (out channels, kernel, stride) convolutions
in the reference itself, kept here as the oracle; and a new architecture
added as one new file, with no other file of the benchmark edited."""
import dataclasses
import hashlib
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from port_bench.bounds import model_flops
from port_bench.reference import rainbow as ref
from port_bench.tests.conftest import BENCH, copy_bench

PRECISIONS = {"float32": ref.Precision(torch.float32),
              "bfloat16": ref.Precision(torch.bfloat16),
              "tf32": ref.Precision(torch.float32, "tf32"),
              "fp8": ref.Precision(torch.bfloat16, "fp8")}
ACTIONS = 6


# ------------------------------------------------------ the parent's path --

OLD_CONVS = {"canonical": ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
             "data-efficient": ((32, 5, 5), (64, 5, 5))}


def old_flat(h):
    s, c = h.frame, h.history
    for c, k, st in OLD_CONVS[h.architecture]:
        s = (s - k) // st + 1
    return s * s * c


def old_param_shapes(h, actions):
    out, cin = {}, h.history
    for i, (cout, k, _s) in enumerate(OLD_CONVS[h.architecture]):
        out[f"convs.{2 * i}.weight"] = (cout, cin, k, k)
        out[f"convs.{2 * i}.bias"] = (cout,)
        cin = cout
    flat = old_flat(h)
    dims = {"fc_h_v": (flat, h.hidden), "fc_h_a": (flat, h.hidden),
            "fc_z_v": (h.hidden, h.atoms),
            "fc_z_a": (h.hidden, actions * h.atoms)}
    for name, (din, dout) in dims.items():
        out.update({f"{name}.weight_mu": (dout, din),
                    f"{name}.weight_sigma": (dout, din),
                    f"{name}.bias_mu": (dout,), f"{name}.bias_sigma": (dout,)})
    return out


def old_noisy_dims(h, actions):
    s = old_param_shapes(h, actions)
    return {n: tuple(reversed(s[f"{n}.weight_mu"])) for n in ref.NOISY}


def old_init_params(h, actions, generator, device):
    shapes = old_param_shapes(h, actions)
    bounds, cin = {}, h.history
    for i, (cout, k, _s) in enumerate(OLD_CONVS[h.architecture]):
        fan = cin * k * k
        bounds[f"convs.{2 * i}.weight"] = bounds[f"convs.{2 * i}.bias"] = \
            1.0 / math.sqrt(fan)
        cin = cout
    for name, (din, dout) in old_noisy_dims(h, actions).items():
        bounds[f"{name}.weight_mu"] = bounds[f"{name}.bias_mu"] = \
            1.0 / math.sqrt(din)
    total = sum(math.prod(shapes[k]) for k in bounds)
    u = torch.rand(total, generator=generator, device=device)
    out, at = {}, 0
    for k, shape in shapes.items():
        if k in bounds:
            n = math.prod(shape)
            out[k] = (u[at:at + n] * (2 * bounds[k]) - bounds[k]).view(shape)
            at += n
        else:
            name, kind = k.split(".")
            din, dout = old_noisy_dims(h, actions)[name]
            fan = din if kind == "weight_sigma" else dout
            out[k] = torch.full(shape, h.noisy_std / math.sqrt(fan),
                                dtype=torch.float32, device=device)
    return out


class _OldRoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, fmt):
        xr, wr = ref.round_to(x, fmt), ref.round_to(w, fmt)
        ctx.save_for_backward(xr, wr)
        ctx.stride, ctx.fmt = stride, fmt
        return F.conv2d(xr, wr, None, stride=stride)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ref.round_to(g, ctx.fmt)
        dx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, stride=ctx.stride)
        dw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, stride=ctx.stride)
        return dx, dw, None, None


def _old_conv(x, w, b, stride, prec):
    if prec.rounding is None:
        return F.conv2d(x, w, b, stride=stride)
    return (_OldRoundedConv.apply(x, w, stride, prec.rounding)
            + b[:, None, None])


def old_streams(p, h, x_u8, eps, prec):
    x = (x_u8.float() / 255.0).to(prec.dtype).permute(0, 3, 1, 2)
    for i, (_c, _k, stride) in enumerate(OLD_CONVS[h.architecture]):
        w = p[f"convs.{2 * i}.weight"].to(prec.dtype)
        b = p[f"convs.{2 * i}.bias"].to(prec.dtype)
        x = torch.relu(_old_conv(x, w, b, stride, prec))
    return _head(p, x.reshape(x.shape[0], -1), eps, prec)


def _head(p, feat, eps, prec):
    out = []
    for hid, z in (("fc_h_v", "fc_z_v"), ("fc_h_a", "fc_z_a")):
        y = ref.noisy_linear(p, hid, feat, eps[hid], prec, relu=True)
        out.append(ref.noisy_linear(p, z, y, eps[z], prec))
    return out


def old_forward_flops(architecture, history, frame, hidden, atoms, actions):
    macs, s, cin = 0, frame, history
    for cout, k, st in OLD_CONVS[architecture]:
        s = (s - k) // st + 1
        macs += s * s * cout * k * k * cin
        cin = cout
    flat = s * s * cin
    macs += 2 * (flat * hidden) * 2
    macs += 2 * (hidden * atoms) + 2 * (hidden * actions * atoms)
    return 2 * macs


# ------------------------------------------------------------ the checks --

def hyper(architecture, frame=84, history=4, hidden=32):
    return ref.Hyper(
        architecture=architecture, hidden=hidden, atoms=51, v_min=-10.0,
        v_max=10.0, noisy_std=0.1, history=history, frame=frame,
        multi_step=3, discount=0.99, priority_exponent=0.5,
        priority_weight=0.4, learning_rate=1e-4, adam_eps=1.5e-4,
        norm_clip=10.0, reward_clip=1.0, batch_size=4, learns_per_iter=1,
        num_envs=4, capacity_per_env=64, learn_start=0, target_update=64,
        total_steps=1000, compute_dtype="float32", adam_mu_dtype="float32",
        per_env_noise=True)


def _weights(h, init, seed=5):
    return init(h, ACTIONS, torch.Generator().manual_seed(seed), "cpu")


def _inputs(h, dims, seed=6):
    """A batch of 4 uint8 stacks, per-row noise of the noisy layers of
    (in, out) ``dims``, and the coefficients of a fixed linear function of
    the streams."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (4, h.frame, h.frame, h.history),
                      generator=g, dtype=torch.uint8)
    eps = {k: (ref.scaled_noise(g, (4, din), "cpu"),
               ref.scaled_noise(g, (4, dout), "cpu"))
           for k, (din, dout) in dims.items()}
    cv = torch.randn((4, h.atoms), generator=g)
    ca = torch.randn((4, ACTIONS * h.atoms), generator=g)
    return x, eps, cv, ca


def _streams_and_grads(streams, params, h, prec, inputs):
    """(v, a), and the gradient of the linear function of them with
    respect to every parameter."""
    x, eps, cv, ca = inputs
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    v, a = streams(leaves, h, x, eps, prec)
    loss = (v.float() * cv).sum() + (a.float() * ca).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return (v.detach(), a.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", sorted(OLD_CONVS))
def test_shapes_and_weights_are_the_parents(arch):
    h = hyper(arch)
    assert h.flat == old_flat(h)
    assert list(ref.param_shapes(h, ACTIONS).items()) == \
        list(old_param_shapes(h, ACTIONS).items())
    new, old = _weights(h, ref.init_params), _weights(h, old_init_params)
    assert list(new) == list(old)
    assert all(torch.equal(new[k], old[k]) for k in old)


@pytest.mark.parametrize("prec", sorted(PRECISIONS))
@pytest.mark.parametrize("arch", sorted(OLD_CONVS))
def test_streams_and_gradients_are_the_parents_bits(arch, prec):
    torch.set_num_threads(2)
    h = hyper(arch)
    p = _weights(h, old_init_params)
    dims = old_noisy_dims(h, ACTIONS)
    new_out, new_g = _streams_and_grads(ref.streams, p, h, PRECISIONS[prec],
                                        _inputs(h, dims))
    old_out, old_g = _streams_and_grads(old_streams, p, h, PRECISIONS[prec],
                                        _inputs(h, dims))
    assert all(torch.equal(n, o) for n, o in zip(new_out, old_out))
    assert list(new_g) == list(old_g)
    for k in old_g:
        assert torch.equal(new_g[k], old_g[k]), k


@pytest.mark.parametrize("args,want", [
    (("canonical", 4, 84, 512, 51, 6), 29_050_880),
    (("data-efficient", 4, 84, 512, 51, 6), 5_650_432),
    (("data-efficient", 4, 84, 256, 51, 18), None),
    (("canonical", 2, 64, 128, 21, 3), None)])
def test_forward_flops_are_the_parents(args, want):
    assert model_flops.forward_flops(*args) == old_forward_flops(*args)
    if want is not None:
        assert model_flops.forward_flops(*args) == want


def test_an_unknown_architecture_names_the_file_it_looked_for(tmp_path):
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "impala.py")):
        ref.torso("impala", tmp_path)
    with pytest.raises(FileNotFoundError, match="no-such-torso.py"):
        ref.param_shapes(hyper("no-such-torso"), ACTIONS)


@pytest.mark.parametrize("stride", [1, 2])
def test_a_padded_rounded_conv_is_the_plain_conv_of_rounded_operands(stride):
    """Under TF32 rounding with operands and output gradient already in
    TF32, the padded convolution and both its gradients are F.conv2d's."""
    g = torch.Generator().manual_seed(7)
    x = ref.round_to(torch.randn(3, 5, 11, 11, generator=g), "tf32")
    w = ref.round_to(torch.randn(6, 5, 3, 3, generator=g), "tf32")
    b = torch.randn(6, generator=g)
    prec = ref.Precision(torch.float32, "tf32")
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = ref.conv(xa, wa, b, stride, prec, padding=1)
    want = F.conv2d(xb, wb, None, stride=stride, padding=1) + b[:, None, None]
    assert got.shape == want.shape and torch.equal(got, want)
    dy = ref.round_to(torch.randn(want.shape, generator=g), "tf32")
    assert torch.equal(ref.round_to(dy, "tf32"), dy)
    got_g = torch.autograd.grad(got, (xa, wa), dy)
    want_g = torch.autograd.grad(want, (xb, wb), dy)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


# ------------------------------------------- a torso from a new file alone --

TOY = '''"""A toy torso: a padded 3x3 convolution, a 3x3 stride-2 max pool with
padding 1, one residual block of two ReLU convolutions, a final ReLU."""
import math

import torch
import torch.nn.functional as F

from port_bench.reference.rainbow import conv

C = 8
CONVS = ("stem", "res.0", "res.1")


def param_shapes(history):
    out = {}
    for name, cin in zip(CONVS, (history, C, C)):
        out[f"{name}.weight"], out[f"{name}.bias"] = (C, cin, 3, 3), (C,)
    return out


def init_bounds(history):
    shapes = param_shapes(history)
    return {f"{n}.{kind}": 1.0 / math.sqrt(shapes[f"{n}.weight"][1] * 9)
            for n in CONVS for kind in ("weight", "bias")}


def forward(p, x, prec):
    w = {k: p[k].to(prec.dtype) for k in param_shapes(x.shape[1])}
    x = conv(x, w["stem.weight"], w["stem.bias"], 1, prec, padding=1)
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    y = conv(torch.relu(x), w["res.0.weight"], w["res.0.bias"], 1, prec,
             padding=1)
    y = conv(torch.relu(y), w["res.1.weight"], w["res.1.bias"], 1, prec,
             padding=1)
    x = torch.relu(x + y)
    return x.reshape(x.shape[0], -1)


def _pooled(frame):
    return (frame + 2 - 3) // 2 + 1


def flat(history, frame):
    return _pooled(frame) ** 2 * C


def macs(history, frame):
    return frame ** 2 * C * 9 * history + 2 * _pooled(frame) ** 2 * C * 9 * C
'''

# Runs with the copy first on sys.path, so that every module of port_bench
# it loads is the copy's, and the copy's reference finds the toy beside it.
TOY_RUN = r'''
import sys
root, io = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch
torch.set_num_threads(2)
from port_bench.bounds import model_flops
from port_bench.reference import rainbow as ref
assert ref.__file__.startswith(root), ref.__file__
given = torch.load(io + "/in.pt")
h = ref.Hyper(**given["hyper"])
p = ref.init_params(h, given["actions"], torch.Generator().manual_seed(5),
                    "cpu")
out = {"flat": h.flat,
       "shapes": list(ref.param_shapes(h, given["actions"]).items()),
       "flops": model_flops.forward_flops("toy", h.history, h.frame, h.hidden,
                                          h.atoms, given["actions"]),
       "weights": p, "streams": {}}
x, eps, cv, ca = given["inputs"]
for name, (dtype, rounding) in given["precisions"].items():
    prec = ref.Precision(getattr(torch, dtype), rounding)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    v, a = ref.streams(leaves, h, x, eps, prec)
    loss = (v.float() * cv).sum() + (a.float() * ca).sum()
    g = torch.autograd.grad(loss, list(leaves.values()))
    feat = ref.torso("toy").forward(p, x.permute(0, 3, 1, 2).to(prec.dtype),
                                    prec)
    out["streams"][name] = (v.detach(), a.detach(), dict(zip(leaves, g)),
                            feat.shape[1])
torch.save(out, io + "/out.pt")
'''


def _digests(bench):
    return {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in bench.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def _toy_streams(p, h, x_u8, eps, prec):
    """The toy network written out: F.conv2d, or the reference's rounded
    convolution under a control, then the noisy head."""
    def c(x, name):
        w = p[f"{name}.weight"].to(prec.dtype)
        b = p[f"{name}.bias"].to(prec.dtype)
        if prec.rounding is None:
            return F.conv2d(x, w, b, padding=1)
        return ref.conv(x, w, b, 1, prec, padding=1)
    x = (x_u8.float() / 255.0).to(prec.dtype).permute(0, 3, 1, 2)
    x = F.max_pool2d(c(x, "stem"), 3, stride=2, padding=1)
    y = c(torch.relu(c(torch.relu(x), "res.0")), "res.1")
    x = torch.relu(x + y)
    return _head(p, x.reshape(x.shape[0], -1), eps, prec)


def test_a_torso_is_added_as_one_new_file(tmp_path):
    torch.set_num_threads(2)
    before = _digests(BENCH)
    bench = copy_bench(tmp_path / "copy")
    (bench / "reference" / "torsos" / "toy.py").write_text(TOY)
    after = _digests(bench)
    assert set(after) - set(before) == {Path("reference/torsos/toy.py")}
    assert all(before[k] == v for k, v in after.items() if k in before)

    h = hyper("toy", frame=12)
    inputs = _inputs(h, {"fc_h_v": (288, 32), "fc_h_a": (288, 32),
                         "fc_z_v": (32, 51), "fc_z_a": (32, ACTIONS * 51)})
    torch.save({"hyper": dataclasses.asdict(h), "actions": ACTIONS,
                "inputs": inputs,
                "precisions": {k: (str(v.dtype).split(".")[1], v.rounding)
                               for k, v in PRECISIONS.items()}},
               tmp_path / "in.pt")
    proc = subprocess.run(
        [sys.executable, "-c", TOY_RUN, str(tmp_path / "copy"),
         str(tmp_path)], capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = torch.load(tmp_path / "out.pt")

    # 12x12 stays 12x12 through the padded stem and pools to 6x6, 8 deep
    assert got["flat"] == 6 * 6 * 8
    toy = ref.torso("toy", bench / "reference" / "torsos")
    shapes = dict(got["shapes"])
    assert got["shapes"][:6] == list(toy.param_shapes(4).items())
    assert shapes["fc_h_v.weight_mu"] == (32, 288)
    # the stem 12·12·8·9·4, two residual convolutions 6·6·8·9·8, the head
    macs = (12 * 12 * 8 * 9 * 4 + 2 * 6 * 6 * 8 * 9 * 8
            + 2 * (288 * 32) * 2 + 2 * (32 * 51) + 2 * (32 * 6 * 51))
    assert got["flops"] == 2 * macs == 285_312

    # one uniform draw: the toy's weights first, in its order, then the
    # noisy layers' μ
    bounds = {"stem.weight": 1 / math.sqrt(36), "stem.bias": 1 / math.sqrt(36),
              **{f"res.{i}.{k}": 1 / math.sqrt(72) for i in (0, 1)
                 for k in ("weight", "bias")}}
    for name in ref.NOISY:
        bounds[f"{name}.weight_mu"] = bounds[f"{name}.bias_mu"] = \
            1 / math.sqrt(shapes[f"{name}.weight_mu"][1])
    u = torch.rand(sum(math.prod(shapes[k]) for k in bounds),
                   generator=torch.Generator().manual_seed(5))
    at, p = 0, got["weights"]
    for k, s in got["shapes"]:
        if k in bounds:
            n = math.prod(s)
            assert torch.equal(p[k], (u[at:at + n] * (2 * bounds[k])
                                      - bounds[k]).view(s)), k
            at += n
    assert at == u.numel()

    for name, prec in PRECISIONS.items():
        v, a, grads, width = got["streams"][name]
        assert width == got["flat"]
        (wv, wa), wg = _streams_and_grads(_toy_streams, p, h, prec, inputs)
        assert torch.equal(v, wv) and torch.equal(a, wa), name
        assert list(grads) == list(wg)
        for k in wg:
            assert torch.equal(grads[k], wg[k]), (name, k)
