"""A plain PyTorch Rainbow network with the IMPALA ResNet x4 torso, written
from the papers for the port's tests. It imports nothing of the port,
nothing of JAX and nothing of the JAX package.

The torso is the "large" network of IMPALA (Espeholt et al. 2018,
arXiv:1802.01561, Fig. 3). Per stage a 3x3 convolution (stride 1, padding
1), a 3x3 max pool (stride 2), two residual blocks x + conv2(relu(conv1(
relu(x)))) of 3x3 convolutions (stride 1, padding 1); a ReLU at the end;
the features flattened channel-major. The head is Rainbow's noisy dueling
C51 head (Hessel et al. 2018; Fortunato et al. 2018; Wang et al. 2016;
Bellemare et al. 2017), as Kaixhin/Rainbow's model.py has it.

Departures from the paper, on purpose:
- the width is four times the paper's, 64/128/128 channels, as BBF
  (Schwarzer et al. 2023, arXiv:2305.19452) uses it;
- the pool pads one pixel on both sides (84 -> 42 -> 21 -> 11), as
  PyTorch ports of the network do; TensorFlow's "SAME" pads 84 and 42 on
  the far side only;
- every convolution's weight and bias are drawn U(+-1/sqrt(fan_in)),
  PyTorch's Conv2d default, as the Nature torso's are in Kaixhin/Rainbow;
- the head is Rainbow's at ``hidden`` units, not IMPALA's policy and value
  head nor BBF's.
"""
import math

import torch
import torch.nn.functional as F

CHANNELS = (64, 128, 128)
NOISY = ("fc_h_v", "fc_h_a", "fc_z_v", "fc_z_a")


def torso_convs(history):
    """(name, out channels, in channels) of the 15 convolutions, stage by
    stage: the stage's convolution, then each block's two."""
    out, cin = [], history
    for s, c in enumerate(CHANNELS):
        out.append((f"torso.{s}.conv", c, cin))
        for b in range(2):
            out.append((f"torso.{s}.{b}.conv1", c, c))
            out.append((f"torso.{s}.{b}.conv2", c, c))
        cin = c
    return out


def flat(frame):
    for _ in CHANNELS:
        frame = math.floor((frame + 2 - 3) / 2) + 1
    return frame * frame * CHANNELS[-1]


def param_shapes(history, frame, hidden, atoms, actions):
    """Every parameter's shape, the torso's first."""
    out = {}
    for name, cout, cin in torso_convs(history):
        out[name + ".weight"] = (cout, cin, 3, 3)
        out[name + ".bias"] = (cout,)
    n = flat(frame)
    for name, (din, dout) in (("fc_h_v", (n, hidden)), ("fc_h_a", (n, hidden)),
                              ("fc_z_v", (hidden, atoms)),
                              ("fc_z_a", (hidden, actions * atoms))):
        out[name + ".weight_mu"] = out[name + ".weight_sigma"] = (dout, din)
        out[name + ".bias_mu"] = out[name + ".bias_sigma"] = (dout,)
    return out


def init_params(generator, history, frame, hidden, atoms, actions,
                noisy_std=0.1):
    """float32 weights: the convolutions U(+-1/sqrt(9 cin)), the noisy
    layers mu U(+-1/sqrt(in)), sigma_W sigma0/sqrt(in), sigma_b
    sigma0/sqrt(out) (Kaixhin/Rainbow model.py:25-30)."""
    shapes = param_shapes(history, frame, hidden, atoms, actions)
    out = {}
    for name, shape in shapes.items():
        layer, kind = name.rsplit(".", 1)
        if kind in ("weight", "bias"):
            b = 1.0 / math.sqrt(9 * shapes[layer + ".weight"][1])
        elif kind.endswith("_mu"):
            b = 1.0 / math.sqrt(shapes[layer + ".weight_mu"][1])
        else:
            dout, din = shapes[layer + ".weight_mu"]
            fan = din if kind == "weight_sigma" else dout
            out[name] = torch.full(shape, noisy_std / math.sqrt(fan))
            continue
        out[name] = torch.empty(shape).uniform_(-b, b, generator=generator)
    return out


def torso(p, x):
    """NCHW input in the compute dtype -> (B, flat) features."""
    def conv(x, name):
        return F.conv2d(x, p[name + ".weight"].to(x.dtype),
                        p[name + ".bias"].to(x.dtype), stride=1, padding=1)

    for s in range(len(CHANNELS)):
        x = F.max_pool2d(conv(x, f"torso.{s}.conv"), kernel_size=3, stride=2,
                         padding=1)
        for b in range(2):
            residual = x
            x = conv(torch.relu(x), f"torso.{s}.{b}.conv1")
            x = conv(torch.relu(x), f"torso.{s}.{b}.conv2")
            x = residual + x
    x = torch.relu(x)
    return torch.flatten(x, 1)


def noisy_linear(p, name, x, eps):
    """x mu_W^T + mu_b + ((x * eps_in) sigma_W^T) * eps_out + sigma_b *
    eps_out in x's dtype, eps = (eps_in, eps_out) shared over the batch;
    mu only without eps."""
    dt = x.dtype
    y = x @ p[name + ".weight_mu"].to(dt).T + p[name + ".bias_mu"].to(dt)
    if eps is None:
        return y
    e_in, e_out = eps[0].to(dt), eps[1].to(dt)
    return (y + ((x * e_in) @ p[name + ".weight_sigma"].to(dt).T) * e_out
            + p[name + ".bias_sigma"].to(dt) * e_out)


def streams(p, x_nhwc, eps, dtype):
    """The value and advantage streams, (B, atoms) and (B, A * atoms), of
    NHWC float frames, in ``dtype``; ``eps`` maps each noisy layer to its
    noise, or is None (mu only)."""
    feat = torso(p, x_nhwc.to(dtype).permute(0, 3, 1, 2))
    eps = eps or {}
    out = []
    for hid, z in (("fc_h_v", "fc_z_v"), ("fc_h_a", "fc_z_a")):
        h = torch.relu(noisy_linear(p, hid, feat, eps.get(hid)))
        out.append(noisy_linear(p, z, h, eps.get(z)))
    return tuple(out)


def loss(v, a, actions, m, weights):
    """Per-sample C51 cross-entropy -sum_z m log p(s, a) of the dueling
    combine's softmax in float32, and the IS-weighted mean (Kaixhin/Rainbow
    agent.py:126-134)."""
    b, atoms = v.shape
    adv = a.reshape(b, -1, atoms)
    q = v.reshape(b, 1, atoms) + adv - adv.mean(dim=1, keepdim=True)
    logp = torch.log_softmax(q.float(), dim=2)[torch.arange(b), actions]
    per = -(m * logp).sum(1)
    return per, (weights * per).mean()
