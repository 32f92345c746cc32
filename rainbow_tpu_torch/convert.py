"""Params conversion between the JAX package's layout and the port's.

The JAX package keeps a nested dict: ``{"convs": [{"w": HWIO, "b"}, ...],
"fc_h_v": {"w_mu", "w_sigma", "b_mu", "b_sigma"}, ...}``. The port keeps a
flat dict keyed like the reference's state dict (tests/test_torch_import.py:
18-39): ``convs.{0,2,4}.weight`` OIHW (nn.Sequential indices skip the
ReLUs), ``fc_h_v.weight_mu`` and so on; noisy weights are (out, in) in both.
Both directions work on numpy arrays or anything ``np.asarray`` takes, so no
JAX import is needed here.
"""
from __future__ import annotations

import numpy as np
import torch

from rainbow_tpu_torch.models.dqn import NOISY_LAYERS

_NOISY = (("w_mu", "weight_mu"), ("w_sigma", "weight_sigma"),
          ("b_mu", "bias_mu"), ("b_sigma", "bias_sigma"))


def params_from_jax(tree: dict, device="cpu") -> dict:
    """JAX-package params (nested dict of arrays) → the port's flat dict of
    float32 tensors on ``device``."""
    out = {}
    for i, conv in enumerate(tree["convs"]):
        w = np.transpose(np.asarray(conv["w"]), (3, 2, 0, 1))  # HWIO → OIHW
        out[f"convs.{2 * i}.weight"] = w
        out[f"convs.{2 * i}.bias"] = np.asarray(conv["b"])
    for name in NOISY_LAYERS:
        for jk, tk in _NOISY:
            out[f"{name}.{tk}"] = np.asarray(tree[name][jk])
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")).to(device)
            for k, v in out.items()}


def params_to_jax(params: dict) -> dict:
    """The port's flat dict → the JAX package's nested dict of numpy arrays."""
    sd = {k: v.detach().cpu().numpy() for k, v in params.items()}
    conv_ids = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("convs.")})
    return {
        "convs": [{"w": np.transpose(sd[f"convs.{i}.weight"], (2, 3, 1, 0)),
                   "b": sd[f"convs.{i}.bias"]} for i in conv_ids],
        **{name: {jk: sd[f"{name}.{tk}"] for jk, tk in _NOISY}
           for name in NOISY_LAYERS},
    }
