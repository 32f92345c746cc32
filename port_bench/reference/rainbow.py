"""Plain PyTorch reference of one Trainer iteration of Rainbow: the batched
prioritized learner round, the target sync, the replay append with the
frame stack, and the noisy act.

It follows the published algorithm (Hessel et al. 2018; Kaixhin/Rainbow's
model.py, agent.py, memory.py and main.py) in the lockstep batched form
that the system under test runs: every env owns a ring of ``C`` columns
written at one shared head; a learner round draws all its batches at once
against the round-start priorities; the noise of every noisy layer is
factorised and given from outside. Nothing here imports the system under
test: the benchmark hands this module the same inputs it hands the program
(weights, uniforms, noise, the engine's steps) and the program's state at
the start of a call, and this module works the call out again.

The torso, the convolutional network in front of the noisy head, is the
configuration's ``architecture``: ``torsos/<architecture>.py`` beside this
file, found by name (names may hold ``-``). Each torso file gives, in plain
PyTorch and importing nothing of the program:

    param_shapes(history)   {name: shape}, in the order the weights are drawn
    init_bounds(history)    {name: b} of the U(±b) draw of each of them
    forward(p, x, prec)     NCHW input in the compute dtype -> (B, flat)
    flat(history, frame)    the width of forward's output
    macs(history, frame)    forward's multiply-adds, counted from the shapes

``Precision`` says how to compute: the compute dtype of the network
(float32 or bfloat16) and, for a control, the rounding of every
convolution's and matrix product's operands, forward and backward, to a
lower format ("tf32": 10-bit mantissa, round to nearest even; "fp8": e4m3
with one scale per tensor).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

TORSOS = Path(__file__).resolve().parent / "torsos"
NOISY = ("fc_h_v", "fc_h_a", "fc_z_v", "fc_z_a")
ADAM_B1, ADAM_B2 = 0.9, 0.999


@dataclasses.dataclass(frozen=True)
class Hyper:
    """The configuration as the benchmark's files state it."""
    architecture: str
    hidden: int
    atoms: int
    v_min: float
    v_max: float
    noisy_std: float
    history: int
    frame: int
    multi_step: int
    discount: float
    priority_exponent: float
    priority_weight: float
    learning_rate: float
    adam_eps: float
    norm_clip: float
    reward_clip: float
    batch_size: int
    learns_per_iter: int
    num_envs: int
    capacity_per_env: int
    learn_start: int
    target_update: int
    total_steps: int
    compute_dtype: str
    adam_mu_dtype: str
    per_env_noise: bool

    @property
    def flat(self) -> int:
        return torso(self.architecture).flat(self.history, self.frame)


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float32
    rounding: Optional[str] = None  # None, "tf32" or "fp8"


def torso(architecture: str, directory: Path = TORSOS):
    """The torso file of ``architecture`` (``directory/<architecture>.py``),
    loaded from its path once."""
    path = Path(directory) / f"{architecture}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no torso for architecture "
                                f"{architecture!r}: {path} is missing")
    name = "port_bench_torso_" + architecture.replace("-", "_").replace(
        ".", "_")
    mod = sys.modules.get(name)
    if mod is None or Path(mod.__file__) != path:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod


def param_shapes(h: Hyper, actions: int) -> Dict[str, tuple]:
    """Every parameter's shape, in Kaixhin/Rainbow's state-dict names: the
    torso's, then the noisy layers'."""
    out = dict(torso(h.architecture).param_shapes(h.history))
    dims = {"fc_h_v": (h.flat, h.hidden), "fc_h_a": (h.flat, h.hidden),
            "fc_z_v": (h.hidden, h.atoms),
            "fc_z_a": (h.hidden, actions * h.atoms)}
    for name, (din, dout) in dims.items():
        out.update({f"{name}.weight_mu": (dout, din),
                    f"{name}.weight_sigma": (dout, din),
                    f"{name}.bias_mu": (dout,), f"{name}.bias_sigma": (dout,)})
    return out


def noisy_dims(h: Hyper, actions: int) -> Dict[str, tuple]:
    s = param_shapes(h, actions)
    return {n: tuple(reversed(s[f"{n}.weight_mu"])) for n in NOISY}


# --------------------------------------------------------------- rounding --

def round_to(x: torch.Tensor, fmt: Optional[str]) -> torch.Tensor:
    """``x`` rounded to ``fmt`` and returned in its own dtype."""
    if fmt is None:
        return x
    if fmt == "tf32":
        b = x.float().contiguous().view(torch.int32)
        b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
        return b.view(torch.float32).to(x.dtype)
    if fmt == "fp8":
        s = x.detach().abs().amax().float().clamp(min=1e-30) / 448.0
        return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(
            x.dtype)
    raise ValueError(f"unknown rounding {fmt!r}")


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, fmt):
        xr, wr = round_to(x, fmt), round_to(w, fmt)
        ctx.save_for_backward(xr, wr)
        ctx.fmt = fmt
        return xr @ wr.T

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_to(g, ctx.fmt)
        return gr @ wr, gr.T @ xr, None


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, fmt):
        xr, wr = round_to(x, fmt), round_to(w, fmt)
        ctx.save_for_backward(xr, wr)
        ctx.stride, ctx.padding, ctx.fmt = stride, padding, fmt
        return F.conv2d(xr, wr, None, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = round_to(g, ctx.fmt)
        kw = {"stride": ctx.stride, "padding": ctx.padding}
        dx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, **kw)
        dw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, **kw)
        return dx, dw, None, None, None


def _matmul(x, w, prec: Precision):
    """x @ wᵀ in the operands' dtype."""
    if prec.rounding is None:
        return x @ w.T
    return _RoundedMatmul.apply(x, w, prec.rounding)


def conv(x, w, b, stride, prec: Precision, padding=0):
    """A convolution with bias, its operands rounded as ``prec`` says; the
    torsos' one convolution."""
    if prec.rounding is None:
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    return _RoundedConv.apply(x, w, stride, padding,
                              prec.rounding) + b[:, None, None]


# ---------------------------------------------------------------- network --

def noisy_linear(p: dict, name: str, x, eps, prec: Precision, relu=False):
    """Factorised noisy linear (Fortunato et al. 2018; Kaixhin model.py):
    W = μ_W + σ_W ⊙ (ε_out ⊗ ε_in), b = μ_b + σ_b ⊙ ε_out, applied without
    forming W: x·μ_Wᵀ + ((x ⊙ ε_in)·σ_Wᵀ) ⊙ ε_out + μ_b + σ_b ⊙ ε_out.
    ``eps`` is (ε_in, ε_out), shared (in,)/(out,) or per row (B, ·)."""
    dt = x.dtype
    w_mu, w_sig = p[f"{name}.weight_mu"].to(dt), p[f"{name}.weight_sigma"].to(dt)
    b_mu, b_sig = p[f"{name}.bias_mu"].to(dt), p[f"{name}.bias_sigma"].to(dt)
    e_in, e_out = eps[0].to(dt), eps[1].to(dt)
    y = _matmul(x, w_mu, prec) + b_mu
    y = y + _matmul(x * e_in, w_sig, prec) * e_out + b_sig * e_out
    return torch.relu(y) if relu else y


def streams(p: dict, h: Hyper, x_u8: torch.Tensor, eps: dict,
            prec: Precision):
    """Value and advantage streams of uint8 NHWC stacks (B, F, F, H):
    (B, atoms) and (B, A·atoms) in the compute dtype."""
    x = (x_u8.float() / 255.0).to(prec.dtype).permute(0, 3, 1, 2)
    feat = torso(h.architecture).forward(p, x, prec)
    out = []
    for hid, z in (("fc_h_v", "fc_z_v"), ("fc_h_a", "fc_z_a")):
        y = noisy_linear(p, hid, feat, eps[hid], prec, relu=True)
        out.append(noisy_linear(p, z, y, eps[z], prec))
    return out


def logits(v, a, atoms: int):
    """Dueling combine (Wang et al. 2016) in the streams' dtype, then
    float32: (B, A, atoms)."""
    b = v.shape[0]
    aa = a.reshape(b, -1, atoms)
    return (v.reshape(b, 1, atoms) + aa - aa.mean(dim=1, keepdim=True)).float()


def support(h: Hyper, device) -> torch.Tensor:
    return torch.linspace(h.v_min, h.v_max, h.atoms, dtype=torch.float32,
                          device=device)


def q_values(p, h: Hyper, x_u8, eps, prec: Precision, block: int = 2048):
    """Expected Q per action, Σ_z z·softmax(logits), (B, A) float32."""
    z = support(h, x_u8.device)
    out = []
    with torch.no_grad():
        for s in range(0, x_u8.shape[0], block):
            e = _rows(eps, slice(s, s + block))
            v, a = streams(p, h, x_u8[s:s + block], e, prec)
            out.append((torch.softmax(logits(v, a, h.atoms), 2) * z).sum(2))
    return torch.cat(out)


def _rows(eps: dict, rows: slice) -> dict:
    """Per-row noise restricted to ``rows``; shared noise as it is."""
    return {k: tuple(t[rows] if t.dim() == 2 else t for t in pair)
            for k, pair in eps.items()}


# ----------------------------------------------------------------- replay --

def sample_round(ring: dict, h: Hyper, u: torch.Tensor, beta: float,
                 nb: int, bs: int) -> dict:
    """Stratified proportional draws over every env's ring (Schaul et al.
    2016; Kaixhin memory.py:64-82, 124-155) and their n-step windows.

    The leaves are the priorities, env-major, zero where a transition's
    (−history+1 .. +n) window crosses the write head; they sit in a sum
    tree padded to a power of two, each node the float32 sum of its two
    children. Draw j takes the value (j + u_j)·total/B and descends: right
    when the value exceeds the left child's sum, less that sum. Draw j goes
    to row j // nb of batch j % nb. IS weights (N·P(i))^−β, N the stored
    transitions, normalised by each batch's largest."""
    pri = ring["priorities"]
    e_n, c = pri.shape
    idx_head = int(ring["index"])
    hist, n = h.history, h.multi_step
    pos = torch.arange(c, device=pri.device)
    valid = ((idx_head - pos) % c > n) & ((pos - idx_head) % c >= hist)
    leaves = torch.where(valid[None], pri, torch.zeros_like(pri)).reshape(-1)
    size = 1 << (leaves.numel() - 1).bit_length()
    level = torch.zeros(size, dtype=torch.float32, device=pri.device)
    level[:leaves.numel()] = leaves
    tree = [level]
    while tree[-1].numel() > 1:
        tree.append(tree[-1][0::2] + tree[-1][1::2])
    total = tree[-1][0]
    b = nb * bs
    seg = total / torch.tensor(float(b), dtype=torch.float32,
                               device=pri.device)
    value = (torch.arange(b, dtype=torch.float32, device=pri.device) + u) * seg
    node = torch.zeros(b, dtype=torch.int64, device=pri.device)
    for lv in reversed(tree[:-1]):
        left = lv[2 * node]
        right = value > left
        node = 2 * node + right
        value = value - torch.where(right, left, torch.zeros_like(left))
    node = node.clamp(max=leaves.numel() - 1)
    p = level[node]
    env, col = node // c, node % c
    offs = torch.arange(-hist + 1, n + 1, device=pri.device)
    wi = (col[:, None] + offs) % c
    eb = env[:, None]
    first = ring["timesteps"][eb, wi] == 0
    w_len = hist + n
    blank = [torch.zeros_like(first[:, 0]) for _ in range(w_len)]
    for t in range(hist - 2, -1, -1):  # frames before an episode start
        blank[t] = blank[t + 1] | first[:, t + 1]
    for t in range(hist, w_len):  # frames after a terminal
        blank[t] = blank[t - 1] | first[:, t]
    blank = torch.stack(blank, 1)
    store = ring["frames"]  # (E, written columns, F·F); the rest are zero
    inside = wi < store.shape[1]
    frames = store[eb, wi.clamp(max=store.shape[1] - 1)]
    frames = frames.masked_fill((blank | ~inside)[..., None], 0)
    rew = ring["rewards"][eb, wi].masked_fill(blank, 0.0)
    ret = torch.zeros(b, dtype=torch.float32, device=pri.device)
    for k in range(n - 1, -1, -1):
        ret = ret + (h.discount ** k) * rew[:, hist - 1 + k]
    nonterm = (ring["nonterminal"][eb, wi] & ~blank)[:, w_len - 1].float()
    stored = (c if bool(ring["full"]) else idx_head) * e_n
    prob = p / total.clamp(min=1e-12)
    w = (stored * prob) ** (-beta)
    w = torch.where((p > 0) & (total > 0), w, torch.zeros_like(w))
    # Draw j -> (batch j % nb, row j // nb).
    order = torch.arange(b, device=pri.device).view(bs, nb).T.reshape(-1)
    f = h.frame
    win = frames[order].view(nb, bs, w_len, f, f)
    w = w[order].view(nb, bs)
    w = w / w.amax(dim=1, keepdim=True).clamp(min=1e-12)
    return {"idx": node[order].view(nb, bs),
            "states": win[:, :, :hist].permute(0, 1, 3, 4, 2),
            "next_states": win[:, :, n:n + hist].permute(0, 1, 3, 4, 2),
            "actions": ring["actions"][env, col][order].view(nb, bs).long(),
            "returns": ret[order].view(nb, bs),
            "nonterminals": nonterm[order].view(nb, bs),
            "weights": w}


def project(probs, returns, nonterminals, h: Hyper):
    """The C51 projection of Tz = R + γⁿ z (for non-terminals) onto the
    support (Bellemare et al. 2017; Kaixhin agent.py:79-92), with the
    hat kernel max(0, 1 − |b − j|), which keeps all the mass on an atom that
    b hits exactly."""
    z = support(h, probs.device)
    dz = (h.v_max - h.v_min) / (h.atoms - 1)
    tz = returns[:, None] + nonterminals[:, None] * (h.discount
                                                     ** h.multi_step) * z
    bpos = (tz.clamp(h.v_min, h.v_max) - h.v_min) / dz
    j = torch.arange(h.atoms, dtype=torch.float32, device=probs.device)
    hat = (1.0 - (bpos[:, :, None] - j).abs()).clamp(0.0, 1.0)
    return torch.einsum("bi,bij->bj", probs, hat)


# -------------------------------------------------------------- optimizer --

def clip_adam(params: dict, grads: dict, mu: dict, nu: dict, count: int,
              h: Hyper) -> int:
    """Global-norm clip then Adam (Kingma & Ba; optax clip_by_global_norm,
    scale_by_adam, scale(−lr)), in place. A bfloat16 first moment is kept
    as optax keeps it: b1·μ a bfloat16 product, μ̂ from the float32 μ
    before it is stored."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    count = min(count + 1, 2 ** 31 - 1)
    f32 = torch.float32
    step = torch.tensor(float(count), dtype=f32)
    bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, dtype=f32), step)
    bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, dtype=f32), step)
    b1_bf16 = torch.tensor(ADAM_B1, dtype=torch.bfloat16)
    for k, p in params.items():
        g = grads[k].float()
        g = torch.where(norm < h.norm_clip, g, (g / norm) * h.norm_clip)
        m = mu[k]
        decayed = ((m * b1_bf16.to(m.device)).float()
                   if m.dtype == torch.bfloat16 else ADAM_B1 * m)
        m_new = (1 - ADAM_B1) * g + decayed
        v_new = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
        upd = (m_new / bc1.to(p.device)) / (torch.sqrt(v_new / bc2.to(
            p.device)) + h.adam_eps)
        p.copy_(p + (-h.learning_rate) * upd)
        m.copy_(m_new)
        nu[k].copy_(v_new)
    return count


# ---------------------------------------------------------------- the call --

def learner_round(agent: dict, ring: dict, h: Hyper, actions: int,
                  beta: float, draws: dict, prec: Precision) -> dict:
    """One batched learner round, in place on ``agent`` and ``ring``'s
    priorities; returns the per-sample losses (nb, bs), the sampled leaves,
    the first update's gradient norm per leaf and each row's margin of the
    double-Q argmax (its best Q over its second), (nb, bs)."""
    nb, bs = h.learns_per_iter, h.batch_size
    big = sample_round(ring, h, draws["u"], beta, nb, bs)
    z = support(h, draws["u"].device)
    rows = big["next_states"].reshape((nb * bs,) + big["next_states"].shape[2:])
    pns = []
    with torch.no_grad():
        for s in range(0, rows.shape[0], 2048):
            e = _rows(draws["target"], slice(s, s + 2048))
            v, a = streams(agent["target"], h, rows[s:s + 2048], e, prec)
            pns.append(torch.softmax(logits(v, a, h.atoms), 2))
    pns = torch.cat(pns).view(nb, bs, actions, h.atoms)
    losses, grad_norms, margins = [], None, []
    for i in range(nb):
        eps = {k: (ei[i], eo[i]) for k, (ei, eo) in draws["online"].items()}
        with torch.no_grad():
            v, a = streams(agent["params"], h, big["next_states"][i], eps, prec)
            q = (torch.softmax(logits(v, a, h.atoms), 2) * z).sum(2)
            a_star = q.argmax(1)
            top2 = q.topk(2, dim=1).values
            margins.append(top2[:, 0] - top2[:, 1])
            m = project(pns[i][torch.arange(bs, device=z.device), a_star],
                        big["returns"][i], big["nonterminals"][i], h)
        leaves = {k: t.detach().clone().requires_grad_()
                  for k, t in agent["params"].items()}
        v, a = streams(leaves, h, big["states"][i], eps, prec)
        logp = torch.log_softmax(logits(v, a, h.atoms), 2)[
            torch.arange(bs, device=z.device), big["actions"][i]]
        per = -(m * logp).sum(1)
        loss = (big["weights"][i] * per).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if grad_norms is None:
            grad_norms = {k: float(g.float().norm()) for k, g in grads.items()}
        with torch.no_grad():
            agent["count"] = clip_adam(agent["params"], grads, agent["mu"],
                                       agent["nu"], agent["count"], h)
        losses.append(per.detach())
    losses = torch.stack(losses)
    # Write-back in draw order, the last draw of a leaf winning (draw j
    # sits at (j % nb, j // nb)).
    draw = torch.arange(nb * bs, device=z.device).view(bs, nb).T
    idx, drw = big["idx"].reshape(-1), draw.reshape(-1)
    pri = losses.reshape(-1) ** h.priority_exponent
    flat = ring["priorities"].view(-1)
    last = torch.full_like(flat, -1, dtype=torch.int64)
    last.scatter_reduce_(0, idx, drw, reduce="amax")
    win = last[idx] == drw
    flat[idx[win]] = pri[win]
    ring["max_priority"] = torch.maximum(ring["max_priority"], pri.max())
    return {"losses": losses, "idx": big["idx"], "grad_norms": grad_norms,
            "margins": torch.stack(margins)}


def append_and_stack(ring: dict, stack: torch.Tensor, step: dict,
                     h: Hyper) -> None:
    """The transition that just ended goes into the ring at the head (the
    stack's newest frame before this step, the action taken, the reward
    clipped to ±reward_clip, ¬done, the episode step, at the largest
    priority so far; Kaixhin memory.py:105-108); then the frame stack takes
    the step's frame by its reset kind: 0 shifts it in, 1 (a lost life)
    shifts in the frame and then the frame after the reset, 2 (a new
    episode) clears the stack to the reset frame (Kaixhin env.py)."""
    n = stack.shape[0]
    col = int(ring["index"])
    c = ring["priorities"].shape[1]
    rewards = step["rewards"].float()
    if h.reward_clip > 0:
        rewards = rewards.clamp(-h.reward_clip, h.reward_clip)
    dones = step["dones"].bool()
    store = ring["frames"]
    if col >= store.shape[1]:
        store = torch.cat([store, store.new_zeros(
            (n, col + 1 - store.shape[1], store.shape[2]))], 1)
    store[:, col] = stack[..., -1].reshape(n, -1)
    ring["frames"] = store
    ring["actions"][:, col] = step["prev_actions"].to(torch.int32)
    ring["rewards"][:, col] = rewards
    ring["timesteps"][:, col] = ring["t"]
    ring["nonterminal"][:, col] = ~dones
    ring["priorities"][:, col] = ring["max_priority"]
    ring["index"] = (col + 1) % c
    ring["full"] = bool(ring["full"]) or ring["index"] == 0
    ring["t"] = torch.where(dones, torch.zeros_like(ring["t"]), ring["t"] + 1)
    obs = step["obs"]
    reset = torch.zeros_like(obs)
    keep = step["reset_idx"] < n
    reset[step["reset_idx"][keep].long()] = step["reset_packed"][keep]
    kinds = step["kinds"].long()[:, None, None, None]
    rolled = torch.cat([stack[..., 1:], obs[..., None]], -1)
    life = torch.cat([stack[..., 2:], obs[..., None], reset[..., None]], -1)
    fresh = torch.cat([torch.zeros_like(stack[..., :-1]), reset[..., None]], -1)
    stack.copy_(torch.where(kinds == 0, rolled,
                            torch.where(kinds == 1, life, fresh)))


def schedule(h: Hyper, iteration: int):
    """(T, learning, β, the number of updates, target sync) of the Trainer's
    1-based iteration: T grows by num_envs an iteration; β anneals linearly
    from β₀ to 1 between learn start and T-max; the target syncs on the
    first learning iteration at or past each multiple of target_update,
    counted from the first (Kaixhin main.py:150-178, batched)."""
    nxt = h.target_update
    for it in range(1, iteration + 1):
        t = it * h.num_envs
        learning = t >= h.learn_start
        sync = learning and t >= nxt
        if sync:
            nxt += h.target_update
    rate = (1.0 - h.priority_weight) / max(h.total_steps - h.learn_start, 1)
    beta = min(1.0, h.priority_weight + (t - h.learn_start) * rate) \
        if learning else 0.0
    return t, learning, beta, h.learns_per_iter if learning else 0, sync


def follow_call(state: dict, inputs: dict, h: Hyper, actions: int,
                prec: Precision) -> dict:
    """One Trainer iteration from ``state`` (the program's at the call's
    start, device tensors, modified in place): the round, the target sync,
    the append and the act. Returns what the call produced."""
    agent, ring, stack = state["agent"], state["ring"], state["stack"]
    out = learner_round(agent, ring, h, actions, inputs["beta"],
                        inputs["draws"], prec)
    if inputs["sync_target"]:
        for k, v in agent["params"].items():
            agent["target"][k].copy_(v)
    append_and_stack(ring, stack, inputs["step"], h)
    out["q"] = q_values(agent["params"], h, stack, inputs["act_noise"], prec)
    out["loss"] = out["losses"].mean()
    return out


def init_params(h: Hyper, actions: int, generator: torch.Generator,
                device) -> Dict[str, torch.Tensor]:
    """Weights as the published network draws them, float32: the torso's
    by its ``init_bounds`` (the convolutions U(±1/√fan_in) for weight and
    bias, PyTorch's Conv2d default), noisy μ U(±1/√in), σ_W = σ₀/√in, σ_b =
    σ₀/√out (Kaixhin model.py:25-30). One uniform draw on ``device`` for
    all of them, the torso's first in its order, then the noisy layers'."""
    shapes = param_shapes(h, actions)
    bounds = dict(torso(h.architecture).init_bounds(h.history))
    for name, (din, dout) in noisy_dims(h, actions).items():
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
            din, dout = noisy_dims(h, actions)[name]
            fan = din if kind == "weight_sigma" else dout
            out[k] = torch.full(shape, h.noisy_std / math.sqrt(fan),
                                dtype=torch.float32, device=device)
    return out


def scaled_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """f(n) = sign(n)·√|n| of standard normals (Fortunato et al. 2018)."""
    n = torch.randn(shape, generator=generator, device=device)
    return n.sign() * n.abs().sqrt()


def draw_noise(h: Hyper, actions: int, generator, lead: tuple,
               device) -> dict:
    """Factorised noise for every noisy layer with leading shape ``lead``:
    {layer: (ε_in, ε_out)}."""
    return {k: (scaled_noise(generator, lead + (din,), device),
                scaled_noise(generator, lead + (dout,), device))
            for k, (din, dout) in noisy_dims(h, actions).items()}
