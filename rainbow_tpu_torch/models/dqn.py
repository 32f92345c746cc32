"""C51 dueling DQN with noisy heads (rainbow_tpu/models/dqn.py; reference
model.py:49-85), in front of one of three torsos: the Nature net
(``canonical``), the data-efficient net, and the IMPALA ResNet at four
times its width (``impala-x4``).

Params are a flat dict keyed like the reference's state dict: the torso's
convolutions (OIHW) and biases first, ``convs.{0,2,4}.weight`` and
``.bias`` for the two conv stacks, ``torso.<stage>.conv.*`` and
``torso.<stage>.<block>.conv{1,2}.*`` for the IMPALA ResNet; then
``fc_h_v.weight_mu``, ``fc_h_v.weight_sigma``, ``fc_h_v.bias_mu``,
``fc_h_v.bias_sigma`` and the same for ``fc_h_a``, ``fc_z_v``, ``fc_z_a``.
The input stays NHWC float as in the JAX package; the torso hands cuDNN a
permuted view and flattens channel-major (dqn.py:77-80). That view is
channels-last for the actor's frame stacks, but NCHW for the learner's
batches, whose K6 windows hold each frame's 84x84 plane whole;
``torso_inputs()`` counts the forwards by architecture and by which of the
two came. The IMPALA ResNet makes its input channels-last and keeps every
tensor so.
"""
from __future__ import annotations

import functools
import threading
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.models.noisy import (NoiseStream, draw_scaled_noise,
                                            noisy_linear)
from rainbow_tpu_torch.ops.c51 import support_vector
from rainbow_tpu_torch.ops.head import HeadOut, dueling_head
from rainbow_tpu_torch.utils.logging import span


class ConvStack:
    """Unpadded convolutions, each followed by a ReLU (reference
    model.py:55-63), named ``convs.{0,2,4}`` as its nn.Sequential indexes
    them; ``layers`` holds (out channels, kernel, stride)."""

    def __init__(self, layers: Tuple[Tuple[int, int, int], ...]):
        self.layers = layers

    def convs(self, history: int) -> List[Tuple[str, int, int, int]]:
        """(name, out channels, in channels, kernel) of every convolution,
        in the order the weights are drawn."""
        out, cin = [], history
        for i, (cout, k, _s) in enumerate(self.layers):
            out.append((f"convs.{2 * i}", cout, cin, k))
            cin = cout
        return out

    def flat(self, history: int, frame: int) -> int:
        s = frame
        for _c, k, stride in self.layers:
            s = (s - k) // stride + 1
        return s * s * self.layers[-1][0]

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        for i, (_c, _k, stride) in enumerate(self.layers):
            w = params[f"convs.{2 * i}.weight"].to(x.dtype)
            b = params[f"convs.{2 * i}.bias"].to(x.dtype)
            x = F.relu(F.conv2d(x, w, b, stride=stride))
        return x


class ImpalaResNet:
    """The IMPALA ResNet (Espeholt et al. 2018, Fig. 3, the "large"
    network): per stage of ``channels`` a 3x3 convolution (stride 1,
    padding 1), a 3x3 max pool (stride 2, padding 1 on both sides, as
    PyTorch ports of it pad; TensorFlow's "SAME" pads 84 and 42 on the far
    side only), then two residual blocks x + conv2(relu(conv1(relu(x))));
    a ReLU at the end. Every convolution has a bias."""

    BLOCKS = 2

    def __init__(self, channels: Tuple[int, ...]):
        self.channels = channels

    def convs(self, history: int) -> List[Tuple[str, int, int, int]]:
        out, cin = [], history
        for s, c in enumerate(self.channels):
            out.append((f"torso.{s}.conv", c, cin, 3))
            out += [(f"torso.{s}.{blk}.conv{j}", c, c, 3)
                    for blk in range(self.BLOCKS) for j in (1, 2)]
            cin = c
        return out

    def flat(self, history: int, frame: int) -> int:
        s = frame
        for _c in self.channels:
            s = (s - 1) // 2 + 1  # (s + 2·1 − 3) // 2 + 1
        return s * s * self.channels[-1]

    def forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Every tensor and gradient channels-last, from the input to the
        flatten, so that cuDNN runs its NHWC engines without converting
        around each convolution and the max pools run their NHWC kernels;
        the output channel-major, as the conv stacks give it."""
        def conv(x, name):
            w = _ChannelsLastCast.apply(params[f"{name}.weight"], x.dtype)
            return F.conv2d(x, w, params[f"{name}.bias"].to(x.dtype),
                            padding=1)

        x = x.contiguous(memory_format=torch.channels_last)
        for s in range(len(self.channels)):
            x = F.max_pool2d(conv(x, f"torso.{s}.conv"), 3, stride=2,
                             padding=1)
            for blk in range(self.BLOCKS):
                y = conv(F.relu(x), f"torso.{s}.{blk}.conv1")
                x = x + conv(F.relu(y), f"torso.{s}.{blk}.conv2")
        return _ChannelMajor.apply(F.relu(x))


class _ChannelsLastCast(torch.autograd.Function):
    """An OIHW weight cast to ``dtype`` and laid out channels-last in one
    copy; its gradient comes back in the weight's dtype and OIHW layout,
    also in one copy (autograd's own cast would keep cuDNN's channels-last
    gradient)."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.dtype = w.dtype
        return w.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype, memory_format=torch.contiguous_format), None


class _ChannelMajor(torch.autograd.Function):
    """A channels-last tensor copied to NCHW order, for the channel-major
    flatten; its gradient goes back channels-last. One transposing copy
    each way."""

    @staticmethod
    def forward(ctx, x):
        return x.contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.contiguous(memory_format=torch.channels_last)


# The two conv stacks of the reference (model.py:55-63), which the JAX
# package and Kaixhin/Rainbow also have; the IMPALA ResNet at the x4 width
# of BBF (Schwarzer et al. 2023), which neither has.
CONV_STACKS = {
    "canonical": ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
    "data-efficient": ((32, 5, 5), (64, 5, 5)),
}
TORSOS = {**{name: ConvStack(layers) for name, layers in CONV_STACKS.items()},
          "impala-x4": ImpalaResNet((64, 128, 128))}


# Torso forwards by "<architecture>.<nhwc|nchw>": whether the permuted input
# came channels-last or not, as ``torso`` finds it. Counted under a lock as
# kernels.LAUNCHES are: an asynchronous evaluation runs forwards from a
# second thread.
TORSO_INPUTS = {f"{arch}.{layout}": 0 for arch in TORSOS
                for layout in ("nchw", "nhwc")}
_LOCK = threading.Lock()


def torso_of(architecture: str):
    if architecture not in TORSOS:
        raise ValueError(f"unknown architecture {architecture!r}; have "
                         f"{sorted(TORSOS)}")
    return TORSOS[architecture]


@functools.cache
def flat_size(architecture: str, history: int, frame: int) -> int:
    """The width of the torso's output for a (frame, frame, history)
    input."""
    return torso_of(architecture).flat(history, frame)


NOISY_LAYERS = ("fc_h_v", "fc_h_a", "fc_z_v", "fc_z_a")
NOISY_KEYS = ("weight_mu", "weight_sigma", "bias_mu", "bias_sigma")


def layer(params: dict, name: str) -> dict:
    """One noisy layer's params out of the flat dict."""
    return {k: params[f"{name}.{k}"] for k in NOISY_KEYS}


def _noisy_dims(cfg, action_space: int) -> dict:
    flat, h = cfg.conv_output_size, cfg.hidden_size
    return {"fc_h_v": (flat, h), "fc_h_a": (flat, h),
            "fc_z_v": (h, cfg.atoms), "fc_z_a": (h, action_space * cfg.atoms)}


def param_shapes(cfg, action_space: int) -> dict:
    """The shape of every network param, in init_dqn_params' keys and
    order."""
    shapes = {}
    for name, cout, cin, k in torso_of(cfg.architecture).convs(
            cfg.history_length):
        shapes[f"{name}.weight"] = (cout, cin, k, k)
        shapes[f"{name}.bias"] = (cout,)
    for name, (din, dout) in _noisy_dims(cfg, action_space).items():
        shapes.update({f"{name}.weight_mu": (dout, din),
                       f"{name}.weight_sigma": (dout, din),
                       f"{name}.bias_mu": (dout,),
                       f"{name}.bias_sigma": (dout,)})
    return shapes


def init_dqn_params(cfg, action_space: int, seed: int,
                    device="cuda") -> dict:
    """All network params, float32 on ``device``: the ones the JAX
    package's Trainer starts from for ``seed``, bit for bit, in this
    package's layout (OIHW convs). Convs take U(±1/√fan_in) for weight and
    bias (torch's default Conv2d regime, which the reference relies on),
    noisy layers μ ~ U(±1/√in), σ_w = σ₀/√in, σ_b = σ₀/√out (reference
    model.py:25-30). The JAX Trainer's agent key is the first of
    split(key(seed)) (rainbow_tpu/train.py:532-534), the params' the first
    of that key's three (rainbow_tpu/agent.py:63-64), then one key per conv
    and per noisy layer (rainbow_tpu/models/dqn.py:35-66), each drawn by
    utils.threefry.uniform on the host, so any device gets the same
    params."""
    import numpy as np

    from rainbow_tpu_torch.utils import threefry

    k_agent = threefry.split(threefry.key(seed), 2)[0]
    k_params = threefry.split(k_agent, 3)[0]
    convs = torso_of(cfg.architecture).convs(cfg.history_length)
    keys = threefry.split(k_params, len(convs) + 4)
    params = {}
    for key, (name, cout, cin, k) in zip(keys, convs):
        k_w, k_b = threefry.split(key, 2)
        bound = 1.0 / (k * k * cin) ** 0.5
        w = threefry.uniform(k_w, (k, k, cin, cout), -bound, bound)  # HWIO
        params[f"{name}.weight"] = w.transpose(3, 2, 0, 1)
        params[f"{name}.bias"] = threefry.uniform(k_b, (cout,), -bound,
                                                  bound)
    dims = _noisy_dims(cfg, action_space)
    for key, name in zip(keys[-4:], NOISY_LAYERS):
        k_w, k_b = threefry.split(key, 2)
        din, dout = dims[name]
        mu_range = np.float32(1.0) / np.sqrt(np.float32(din))
        params.update({
            f"{name}.weight_mu": threefry.uniform(k_w, (dout, din),
                                                  -mu_range, mu_range),
            f"{name}.weight_sigma": np.full((dout, din),
                                            cfg.noisy_std / din ** 0.5,
                                            np.float32),
            f"{name}.bias_mu": threefry.uniform(k_b, (dout,), -mu_range,
                                                mu_range),
            f"{name}.bias_sigma": np.full((dout,),
                                          cfg.noisy_std / dout ** 0.5,
                                          np.float32)})
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(params[k])).to(dev)
            for k in param_shapes(cfg, action_space)}


def torso(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The architecture's torso over NHWC input (B, 84, 84, H) in the
    compute dtype → (B, flat), channel-major: every forward of the network
    (the act, the learner's forwards, the round's target forward,
    evaluation) runs through this function, looked up at call time, counts
    one in TORSO_INPUTS by architecture and the layout its input came in,
    and under a profiler is its range ``rainbow.torso``. cuDNN runs float32
    convolutions in TF32 while ``torch.backends.cudnn.allow_tf32`` is set
    (PyTorch's default); clear it for full float32, as chip_smoke.py
    does."""
    net, x = torso_of(cfg.architecture), x.permute(0, 3, 1, 2)
    nhwc = x.is_contiguous(memory_format=torch.channels_last)
    with _LOCK:
        TORSO_INPUTS[f"{cfg.architecture}.{'nhwc' if nhwc else 'nchw'}"] += 1
    with span("torso"):
        x = net.forward(params, x)
        return x.reshape(x.shape[0], -1)


def torso_inputs() -> dict:
    with _LOCK:
        return dict(TORSO_INPUTS)


def reset_torso_inputs() -> None:
    with _LOCK:
        for k in TORSO_INPUTS:
            TORSO_INPUTS[k] = 0


def draw_noise(cfg, action_space: int, noise: NoiseStream, lead=(),
               device="cuda") -> dict:
    """Pre-draw factored noise for every noisy layer from the stream
    ``noise``, with an optional leading shape (``(B,)`` for one draw per env
    row). Returns {layer: (eps_in, eps_out)} float32, for
    ``apply_dqn(noise_eps=...)``: one launch of the noise kernel on a CUDA
    ``device``, its plain version on the CPU."""
    return draw_noise_sets(cfg, action_space, noise, [lead], device)[0]


def draw_noise_sets(cfg, action_space: int, noise: NoiseStream,
                    leads: Sequence[tuple], device="cuda") -> List[dict]:
    """draw_noise for each leading shape in ``leads``, in that order from
    the stream, all in one draw (one launch on a CUDA ``device``)."""
    dims = _noisy_dims(cfg, action_space)
    shapes = [tuple(lead) + (d,) for lead in leads
              for din, dout in dims.values() for d in (din, dout)]
    flat = iter(draw_scaled_noise(noise, shapes, device))
    return [{name: (next(flat), next(flat)) for name in dims}
            for _ in leads]


def _compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _streams(params: dict, cfg, action_space: int, x: torch.Tensor,
             noise: Optional[NoiseStream], per_sample_noise: bool,
             noise_eps: Optional[dict]):
    """Value and advantage streams, (B, atoms) and (B, A·atoms), in the
    compute dtype."""
    x = x.to(_compute_dtype(cfg))
    feat = torso(params, cfg, x)
    if noise_eps is None and noise is not None:
        lead = (x.shape[0],) if per_sample_noise else ()
        noise_eps = draw_noise(cfg, action_space, noise, lead, x.device)
    ne = noise_eps or {}

    def stream(h_name, z_name):
        h = noisy_linear(layer(params, h_name), feat, ne.get(h_name),
                         relu=True)
        return noisy_linear(layer(params, z_name), h, ne.get(z_name))
    return stream("fc_h_v", "fc_z_v"), stream("fc_h_a", "fc_z_a")


def loss_streams(params: dict, cfg, action_space: int, x: torch.Tensor,
                 noise_eps: Optional[dict] = None):
    """The value and advantage streams, (B, atoms) and (B, A·atoms) in the
    compute dtype, as the learner's loss takes them (the forward of
    rainbow_tpu/agent.py:128-129 up to the dueling combine), with pre-drawn
    noise or μ only. Differentiable in ``params`` through the cuDNN torso
    and the noisy-linear kernels' backward."""
    return _streams(params, cfg, action_space, x, None, False, noise_eps)


def forward_head(params: dict, cfg, action_space: int, x: torch.Tensor,
                 noise: Optional[NoiseStream] = None,
                 dist: Optional[str] = None, per_sample_noise: bool = False,
                 noise_eps: Optional[dict] = None,
                 support: Optional[torch.Tensor] = None) -> HeadOut:
    """Network forward through the head epilogue: (dist, q, greedy action,
    max q). ``dist`` selects the distribution output (None, "probs", "log");
    ``support`` defaults to the config's atoms."""
    v, a = _streams(params, cfg, action_space, x, noise, per_sample_noise,
                    noise_eps)
    if support is None:
        support = support_vector(cfg.v_min, cfg.v_max, cfg.atoms, v.device)
    return dueling_head(v, a, support, action_space, dist)


def apply_dqn(params: dict, cfg, action_space: int, x: torch.Tensor,
              noise: Optional[NoiseStream] = None, log: bool = False,
              per_sample_noise: bool = False,
              noise_eps: Optional[dict] = None) -> torch.Tensor:
    """Forward pass: (B, 84, 84, H) NHWC float → (B, A, atoms) float32 atom
    probabilities, or log-probabilities with ``log=True`` (reference
    model.py:69-80). Noise comes from ``noise_eps`` (pre-drawn, see
    ``draw_noise``) or is drawn from the stream ``noise``; with neither the net
    runs μ only (eval mode). bfloat16 compute keeps an fp32 softmax."""
    return forward_head(params, cfg, action_space, x, noise,
                        "log" if log else "probs", per_sample_noise,
                        noise_eps).dist


def q_values(params: dict, cfg, action_space: int, support: torch.Tensor,
             x: torch.Tensor,
             noise: Optional[NoiseStream] = None) -> torch.Tensor:
    """Expected Q per action, Σ_z z·p (reference agent.py:55), (B, A)."""
    return forward_head(params, cfg, action_space, x, noise,
                        support=support).q
