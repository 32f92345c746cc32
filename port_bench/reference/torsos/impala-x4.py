"""The IMPALA ResNet (Espeholt et al. 2018, arXiv:1802.01561, Fig. 3, the
"large" network) at four times its width, 64/128/128 channels, as BBF uses
it (Schwarzer et al. 2023, arXiv:2305.19452). Per stage: a 3x3
convolution (stride 1, padding 1), a 3x3 max pool (stride 2, padding 1),
then two residual blocks x + conv2(relu(conv1(relu(x)))) of 3x3
convolutions (stride 1, padding 1); a ReLU after the last stage. Every
convolution has a bias.

Departures from the paper: the pool pads one pixel on both sides, as
PyTorch ports of the network do (TensorFlow's "SAME" pads 84 and 42 on
the far side only); the weights are drawn U(±1/√fan_in), PyTorch's Conv2d
default, as the other torsos' are."""
import math

import torch
import torch.nn.functional as F

from port_bench.reference.rainbow import conv

CHANNELS = (64, 128, 128)
BLOCKS = 2


def _convs(history: int):
    """(name, out channels, in channels) of each 3x3 convolution, in the
    order the weights are drawn."""
    out, cin = [], history
    for s, c in enumerate(CHANNELS):
        out.append((f"torso.{s}.conv", c, cin))
        out += [(f"torso.{s}.{b}.conv{j}", c, c)
                for b in range(BLOCKS) for j in (1, 2)]
        cin = c
    return out


def param_shapes(history: int) -> dict:
    out = {}
    for name, cout, cin in _convs(history):
        out[f"{name}.weight"] = (cout, cin, 3, 3)
        out[f"{name}.bias"] = (cout,)
    return out


def init_bounds(history: int) -> dict:
    out = {}
    for name, _cout, cin in _convs(history):
        out[f"{name}.weight"] = out[f"{name}.bias"] = 1.0 / math.sqrt(cin * 9)
    return out


def forward(p: dict, x: torch.Tensor, prec) -> torch.Tensor:
    def c(x, name):
        return conv(x, p[f"{name}.weight"].to(prec.dtype),
                    p[f"{name}.bias"].to(prec.dtype), 1, prec, padding=1)

    for s in range(len(CHANNELS)):
        x = F.max_pool2d(c(x, f"torso.{s}.conv"), 3, stride=2, padding=1)
        for b in range(BLOCKS):
            y = c(torch.relu(x), f"torso.{s}.{b}.conv1")
            x = x + c(torch.relu(y), f"torso.{s}.{b}.conv2")
    x = torch.relu(x)
    return x.reshape(x.shape[0], -1)


def _sizes(frame: int):
    """Each stage's input side and its side after the pool."""
    out, s = [], frame
    for _c in CHANNELS:
        out.append((s, (s + 2 - 3) // 2 + 1))
        s = out[-1][1]
    return out


def flat(history: int, frame: int) -> int:
    return _sizes(frame)[-1][1] ** 2 * CHANNELS[-1]


def macs(history: int, frame: int) -> int:
    out, cin = 0, history
    for (side, pooled), c in zip(_sizes(frame), CHANNELS):
        out += side * side * c * 9 * cin
        out += 2 * BLOCKS * pooled * pooled * c * 9 * c
        cin = c
    return out
