"""Params conversion between the JAX package's layout and the port's.

The JAX package keeps a nested dict: ``{"convs": [{"w": HWIO, "b"}, ...],
"fc_h_v": {"w_mu", "w_sigma", "b_mu", "b_sigma"}, ...}``. The port keeps a
flat dict keyed like the reference's state dict (tests/test_torch_import.py:
18-39): ``convs.{0,2,4}.weight`` OIHW (nn.Sequential indices skip the
ReLUs), ``fc_h_v.weight_mu`` and so on; noisy weights are (out, in) in both.
Both directions work on numpy arrays or anything ``np.asarray`` takes, so no
JAX import is needed here. ``opt_state_from_jax`` carries optax's Adam
state across the same way, and ``replay_from_jax`` a replay ring, whose
layout is the same in both packages. Only the two conv stacks have a JAX
layout (NO_SOURCE): the JAX package has no IMPALA ResNet, and
``params_to_jax`` refuses one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rainbow_tpu_torch.agent import AdamState
from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.models.dqn import CONV_STACKS, NOISY_LAYERS, TORSOS
from rainbow_tpu_torch.replay.prioritized import ReplayState

# A noisy layer's (JAX key, port key) pairs.
JAX_NOISY_KEYS = (("w_mu", "weight_mu"), ("w_sigma", "weight_sigma"),
                  ("b_mu", "bias_mu"), ("b_sigma", "bias_sigma"))


# Only the conv stacks (their params ``convs.*``) have a source to import
# or convert: neither the JAX package nor Kaixhin/Rainbow has another torso.
NO_SOURCE = (f"neither the JAX package nor Kaixhin/Rainbow has the "
             f"{', '.join(sorted(set(TORSOS) - set(CONV_STACKS)))} torso, "
             f"only the conv stacks {', '.join(CONV_STACKS)}")


def require_source(architecture: str) -> None:
    if architecture not in CONV_STACKS:
        raise ValueError(f"{architecture}: {NO_SOURCE}")


def require_conv_stack(names) -> None:
    if not any(k.startswith("convs.") for k in names):
        raise ValueError(f"no conv stack (convs.*) in the params: {NO_SOURCE}")


def _flat_from_jax(tree: dict, device, dtype=torch.float32) -> dict:
    """A params-shaped JAX tree → the port's flat dict of ``dtype`` tensors
    on ``device``; values pass through float32, which holds bfloat16 ones
    exactly."""
    dev = resolve_device(device)
    out = {}
    for i, conv in enumerate(tree["convs"]):
        w = np.transpose(np.asarray(conv["w"]), (3, 2, 0, 1))  # HWIO → OIHW
        out[f"convs.{2 * i}.weight"] = w
        out[f"convs.{2 * i}.bias"] = np.asarray(conv["b"])
    for name in NOISY_LAYERS:
        for jk, tk in JAX_NOISY_KEYS:
            out[f"{name}.{tk}"] = np.asarray(tree[name][jk])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C"))
            .to(device=dev, dtype=dtype) for k, v in out.items()}


def params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX-package params (nested dict of arrays) → the port's flat dict of
    float32 tensors on ``device``."""
    return _flat_from_jax(tree, device)


def opt_state_from_jax(opt_state, device="cuda") -> AdamState:
    """The JAX package's optimizer state, optax.chain(clip_by_global_norm,
    adam) (rainbow_tpu/agent.py:43-58), → the port's AdamState on
    ``device``: count, and mu (float32 or bfloat16, as stored) and nu in
    the params' layout."""
    adam = next(s for s in opt_state[1] if hasattr(s, "mu"))
    mu_dtype = (torch.bfloat16 if "bfloat16" in str(
        np.asarray(adam.mu["fc_h_v"]["w_mu"]).dtype) else torch.float32)
    dev = resolve_device(device)
    return AdamState(
        mu=_flat_from_jax(adam.mu, dev, mu_dtype),
        nu=_flat_from_jax(adam.nu, dev),
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                           device=dev))


def replay_from_jax(rep, device="cuda") -> ReplayState:
    """The JAX package's ReplayState (fields as arrays, or anything
    ``np.array`` takes) → the port's ReplayState on ``device``, each field
    with its dtype and shape unchanged."""
    dev = resolve_device(device)
    return ReplayState(**{
        f.name: torch.from_numpy(np.array(getattr(rep, f.name))).to(dev)
        for f in dataclasses.fields(ReplayState)})


def params_to_jax(params: dict) -> dict:
    """The port's flat dict → the JAX package's nested dict of numpy arrays;
    another torso than the conv stacks raises (NO_SOURCE)."""
    require_conv_stack(params)
    sd = {k: v.detach().cpu().numpy() for k, v in params.items()}
    conv_ids = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("convs.")})
    return {
        "convs": [{"w": np.transpose(sd[f"convs.{i}.weight"], (2, 3, 1, 0)),
                   "b": sd[f"convs.{i}.bias"]} for i in conv_ids],
        **{name: {jk: sd[f"{name}.{tk}"] for jk, tk in JAX_NOISY_KEYS}
           for name in NOISY_LAYERS},
    }
