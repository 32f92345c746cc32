"""The Nature DQN torso (Mnih et al. 2015; Kaixhin/Rainbow model.py,
architecture "canonical"): three unpadded convolutions of 32, 64 and 64
channels, kernels 8, 4 and 3, strides 4, 2 and 1, each followed by a ReLU."""
import math

import torch

from port_bench.reference.rainbow import conv

CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (out channels, kernel, stride)


def param_shapes(history: int) -> dict:
    out, cin = {}, history
    for i, (cout, k, _s) in enumerate(CONVS):
        out[f"convs.{2 * i}.weight"] = (cout, cin, k, k)
        out[f"convs.{2 * i}.bias"] = (cout,)
        cin = cout
    return out


def init_bounds(history: int) -> dict:
    out, cin = {}, history
    for i, (cout, k, _s) in enumerate(CONVS):
        out[f"convs.{2 * i}.weight"] = out[f"convs.{2 * i}.bias"] = \
            1.0 / math.sqrt(cin * k * k)
        cin = cout
    return out


def forward(p: dict, x: torch.Tensor, prec) -> torch.Tensor:
    for i, (_c, _k, stride) in enumerate(CONVS):
        w = p[f"convs.{2 * i}.weight"].to(prec.dtype)
        b = p[f"convs.{2 * i}.bias"].to(prec.dtype)
        x = torch.relu(conv(x, w, b, stride, prec))
    return x.reshape(x.shape[0], -1)


def flat(history: int, frame: int) -> int:
    s = frame
    for _c, k, st in CONVS:
        s = (s - k) // st + 1
    return s * s * CONVS[-1][0]


def macs(history: int, frame: int) -> int:
    out, s, cin = 0, frame, history
    for cout, k, st in CONVS:
        s = (s - k) // st + 1
        out += s * s * cout * k * k * cin
        cin = cout
    return out
