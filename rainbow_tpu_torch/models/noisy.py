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


def noisy_linear(params: dict, x: torch.Tensor,
                 eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 per_sample: bool = False, relu: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply a noisy linear layer to x (B, in), float32 or bfloat16.

    ``eps=(eps_in, eps_out)`` is pre-drawn scaled noise, shared or per row;
    else, with a ``generator``, noise is drawn here (per row when
    ``per_sample``); with neither, the layer is μ only. ``relu`` applies a
    ReLU to the output. On CUDA tensors this is one launch of the
    noisy-linear kernel, on CPU tensors its plain version.
    """
    if eps is None and generator is not None:
        lead = (x.shape[0],) if per_sample else ()
        w = params["weight_mu"]
        eps = (scale_noise(generator, lead + (w.shape[1],), x.device),
               scale_noise(generator, lead + (w.shape[0],), x.device))
    if x.is_cuda:
        return ka.noisy_linear_fwd(params, x, eps, relu)
    return noisy_linear_plain(params, x, eps, relu)
