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
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

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


def scale_noise(generator: torch.Generator, shape, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """f(x) = sign(x)·sqrt(|x|) over a standard normal draw
    (reference model.py:32-34)."""
    if isinstance(shape, int):
        shape = (shape,)
    x = torch.randn(shape, generator=generator,
                    device=device or generator.device, dtype=dtype)
    return torch.sign(x) * torch.sqrt(torch.abs(x))


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
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply a noisy linear layer to x (B, in), float32 or bfloat16.

    ``eps=(eps_in, eps_out)`` is pre-drawn scaled noise, shared or per row;
    else, with a ``generator``, noise is drawn here (per row when
    ``per_sample``); with neither, the layer is μ only. ``relu`` applies a
    ReLU to the output. On CUDA tensors this is one launch of the
    noisy-linear kernel, on CPU tensors its plain version; so is its
    backward.
    """
    if eps is None and generator is not None:
        lead = (x.shape[0],) if per_sample else ()
        w = params["weight_mu"]
        eps = (scale_noise(generator, lead + (w.shape[1],), x.device),
               scale_noise(generator, lead + (w.shape[0],), x.device))
    eps_in, eps_out = eps if eps is not None else (None, None)
    return _NoisyLinear.apply(x, params["weight_mu"], params["weight_sigma"],
                              params["bias_mu"], params["bias_sigma"], eps_in,
                              eps_out, relu)
