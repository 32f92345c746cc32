"""Factorised-Gaussian NoisyLinear as functions over explicit params
(rainbow_tpu/models/noisy.py; reference model.py:10-46).

A layer's params are a dict with the reference state dict's names:
``weight_mu``/``weight_sigma`` (out, in) and ``bias_mu``/``bias_sigma``
(out,), float32. Noise is never a stored buffer: it is drawn from an explicit
``torch.Generator`` or passed in pre-drawn, and the (out, in) perturbed
weight is never formed:

    y = x @ μ_wᵀ + ((x · ε_in) @ σ_wᵀ) · ε_out + μ_b + σ_b · ε_out

ε is absent (μ only, the eval path), shared ``(in,)/(out,)``, or per row
``(B, in)/(B, out)`` (an independent draw per env of a batched actor).

The layer is differentiable in x and its four params: a
``torch.autograd.Function`` whose forward and backward are one launch each
of the noisy-linear kernels on CUDA tensors, and their plain versions on CPU
tensors.

Noise comes from a ``NoiseStream`` (seed, offset): a counter-based
Philox4x32-10 stream, so a draw is a pure function of (seed, offset, shapes)
and the CPU and the card draw the same values. On a CUDA device one draw is
one launch of the noise kernel (K2, csrc/noise.cu, which writes down the
word-to-element map); on the CPU its plain version ``philox_noise_plain``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.kernels import noise as k2
from rainbow_tpu_torch.kernels import noisy_linear as ka


def init_noisy_params(generator: torch.Generator, in_features: int,
                      out_features: int, std_init: float,
                      device=None) -> dict:
    """μ ~ U(±1/√in), σ_w = σ₀/√in, σ_b = σ₀/√out (reference model.py:25-30).
    Draws on the generator's device, then moves to ``device`` if given."""
    g = generator
    mu_range = 1.0 / math.sqrt(in_features)
    u = lambda *shape: (torch.rand(shape, generator=g, device=g.device)
                        * (2 * mu_range) - mu_range)
    p = {
        "weight_mu": u(out_features, in_features),
        "weight_sigma": torch.full((out_features, in_features),
                                   std_init / in_features ** 0.5,
                                   device=g.device),
        "bias_mu": u(out_features),
        "bias_sigma": torch.full((out_features,),
                                 std_init / out_features ** 0.5,
                                 device=g.device),
    }
    return {k: v.to(device) for k, v in p.items()} if device else p


@dataclasses.dataclass
class NoiseStream:
    """A noise stream: Philox4x32-10 keyed by ``seed`` (64 bits), at the
    32-bit word position ``offset`` (a multiple of 4). Every draw takes the
    words it uses from ``offset`` and advances it past them."""
    seed: int
    offset: int = 0


_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # and key bumps
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m·x for x in [0, 2^32), in int64 without
    overflow: x is split into 16-bit halves, every partial product < 2^49."""
    lo = m * (x & 0xFFFF)
    t = m * (x >> 16) + (lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo & 0xFFFF)


def philox4x32_10(ctr: torch.Tensor, key: Sequence[int]) -> torch.Tensor:
    """Random123's Philox4x32-10 (Salmon et al., SC'11) of counters ``ctr``
    (…, 4) int64, each word in [0, 2^32), under ``key`` (two 32-bit ints);
    returns (…, 4) int64 words."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack((c0, c1, c2, c3), dim=-1)


def noise_words(shapes: Sequence[tuple]) -> int:
    """The stream words a draw of ``shapes`` uses: four per Philox counter,
    ceil(numel / 4) counters per tensor."""
    return 4 * sum(-(-math.prod(s) // 4) for s in shapes)


def scaled_box_muller_plain(words: torch.Tensor) -> torch.Tensor:
    """Box–Muller and the transform of the noise stream (csrc/noise.cu), in
    float64 with one rounding to float32: ``words`` (..., 2k) int64 in
    [0, 2^32), read as pairs (a, b), gives (..., 2k) float32 with
    sign(z)·√|z| of z = (r cos t, r sin t) in each pair's two places, where
    r = √(−2 ln((a + 1)·2⁻³²)) and t = 2π·b·2⁻³²."""
    w = words.double()
    r = torch.sqrt(-2.0 * torch.log((w[..., 0::2] + 1.0) * 2.0 ** -32))
    t = 6.283185307179586 * (w[..., 1::2] * 2.0 ** -32)
    z = torch.stack((r * torch.cos(t), r * torch.sin(t)), dim=-1)
    eps = torch.sign(z) * torch.sqrt(torch.abs(z))
    return eps.flatten(-2).float()


def philox_noise_plain(seed: int, offset: int, shapes: Sequence[tuple],
                       device="cpu") -> List[torch.Tensor]:
    """Plain version of the noise kernel (K2): for each shape, float32
    sign(n)·√|n| of standard normals n from the stream at (``seed``,
    ``offset``), in csrc/noise.cu's word-to-element map: Philox on int64
    tensors, then scaled_box_muller_plain (float64, one rounding to
    float32). Runs on any device; the kernel replaces it on the card."""
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    base = offset // 4
    outs = []
    for shape in shapes:
        n = math.prod(shape)
        m = -(-n // 4)
        c = torch.arange(base, base + m, dtype=torch.int64, device=device)
        zero = torch.zeros_like(c)
        w = philox4x32_10(torch.stack((c & _MASK32, c >> 32, zero, zero),
                                      dim=-1), key)
        outs.append(scaled_box_muller_plain(w).reshape(-1)[:n].reshape(shape))
        base += m
    return outs


def draw_scaled_noise(stream: NoiseStream, shapes: Sequence[tuple],
                      device="cuda") -> List[torch.Tensor]:
    """One draw of f(n) = sign(n)·√|n| over standard normals (reference
    model.py:32-34), a float32 tensor per shape on ``device``, from
    ``stream``, which it advances. On a CUDA device one launch of the noise
    kernel, on the CPU (``device="cpu"``) its plain version."""
    dev = resolve_device(device)
    shapes = [tuple(s) for s in shapes]
    offset = stream.offset
    stream.offset += noise_words(shapes)
    if dev.type == "cuda":
        return k2.scaled_noise(stream.seed, offset, shapes, dev)
    return philox_noise_plain(stream.seed, offset, shapes, dev)


def scale_noise(stream: NoiseStream, shape, device="cuda") -> torch.Tensor:
    """One tensor of f(n) = sign(n)·√|n| noise from ``stream`` (see
    draw_scaled_noise)."""
    if isinstance(shape, int):
        shape = (shape,)
    return draw_scaled_noise(stream, [shape], device)[0]


def noisy_linear_plain(params: dict, x: torch.Tensor,
                       eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                       relu: bool = False) -> torch.Tensor:
    """Plain version of the noisy-linear kernel: the JAX package's op
    sequence, in x's dtype (params and ε are cast to it, noisy.py:84-94)."""
    dtype = x.dtype
    y = x @ params["weight_mu"].to(dtype).T + params["bias_mu"].to(dtype)
    if eps is not None:
        eps_in, eps_out = (e.to(dtype) for e in eps)
        noise = ((x * eps_in) @ params["weight_sigma"].to(dtype).T) * eps_out
        y = y + noise + params["bias_sigma"].to(dtype) * eps_out
    return torch.relu(y) if relu else y


def noisy_linear_bwd_plain(w_mu: torch.Tensor, w_sig: torch.Tensor,
                           x: torch.Tensor, g: torch.Tensor,
                           eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                           y: Optional[torch.Tensor] = None):
    """Plain version of the noisy-linear backward kernel: the gradients
    jax.grad derives from the JAX package's op sequence, in x's dtype, with
    the parameter grads as float32: (dx, dμ_w, dσ_w, dμ_b, dσ_b). ``y``, the
    layer's output, is given for a layer with a ReLU (the mask is y > 0)."""
    dt = x.dtype
    if y is not None:
        g = torch.where(y > 0, g, torch.zeros_like(g))
    dx = g @ w_mu.to(dt)
    dw_mu = (g.T @ x).float()
    db_mu = g.sum(dim=0).float()
    if eps is None:
        return (dx, dw_mu, torch.zeros_like(w_sig), db_mu,
                torch.zeros_like(db_mu))
    eps_in, eps_out = (e.to(dt) for e in eps)
    ge = g * eps_out
    dx = dx + (ge @ w_sig.to(dt)) * eps_in
    return (dx, dw_mu, (ge.T @ (x * eps_in)).float(), db_mu,
            ge.sum(dim=0).float())


class _NoisyLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_mu, w_sig, b_mu, b_sig, eps_in, eps_out, relu):
        params = {"weight_mu": w_mu, "weight_sigma": w_sig, "bias_mu": b_mu,
                  "bias_sigma": b_sig}
        eps = None if eps_in is None else (eps_in, eps_out)
        fwd = ka.noisy_linear_fwd if x.is_cuda else noisy_linear_plain
        y = fwd(params, x, eps, relu)
        ctx.save_for_backward(x, w_mu, w_sig, eps_in, eps_out,
                              y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w_mu, w_sig, eps_in, eps_out, y = ctx.saved_tensors
        eps = None if eps_in is None else (eps_in, eps_out)
        bwd = ka.noisy_linear_bwd if g.is_cuda else noisy_linear_bwd_plain
        grads = bwd(w_mu, w_sig, x, g.contiguous(), eps, y)
        return (*grads, None, None, None)


def noisy_linear(params: dict, x: torch.Tensor,
                 eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 per_sample: bool = False, relu: bool = False,
                 noise: Optional[NoiseStream] = None) -> torch.Tensor:
    """Apply a noisy linear layer to x (B, in), float32 or bfloat16.

    ``eps=(eps_in, eps_out)`` is pre-drawn scaled noise, shared or per row;
    else, with a ``noise`` stream, noise is drawn here (per row when
    ``per_sample``); with neither, the layer is μ only. ``relu`` applies a
    ReLU to the output. On CUDA tensors this is one launch of the
    noisy-linear kernel, on CPU tensors its plain version; so is its
    backward.
    """
    if eps is None and noise is not None:
        lead = (x.shape[0],) if per_sample else ()
        w = params["weight_mu"]
        eps = tuple(draw_scaled_noise(noise, (lead + (w.shape[1],),
                                              lead + (w.shape[0],)),
                                      x.device))
    eps_in, eps_out = eps if eps is not None else (None, None)
    return _NoisyLinear.apply(x, params["weight_mu"], params["weight_sigma"],
                              params["bias_mu"], params["bias_sigma"], eps_in,
                              eps_out, relu)
