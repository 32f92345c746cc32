"""Bring trained weights into the port: a reference PyTorch ``model.pth``
(rainbow_tpu/utils/torch_import.py:1-96), or a ``model.npz`` that the JAX
package wrote, read without JAX.

    python -m rainbow_tpu_torch.utils.torch_import model.pth model.npz
    python -m rainbow_tpu_torch.cli --evaluate --model model.npz ...

The port keys its params like the reference's state dict (convert.py), so
a state dict converts key for key: the legacy ``conv1.*`` → ``convs.0.*``
remap of pre-refactor checkpoints (reference agent.py:29-32), the
``*_epsilon`` noise buffers dropped (noise is drawn, never stored here),
every tensor float32; no transposition.

The JAX package's ``model.npz`` (rainbow_tpu/checkpoint.py::save_pytree)
holds the leaves as members ``arr_0`` … in the order jax.tree_util's
flatten gives the params dict, beside a pickled treedef that needs JAX to
load and the flags ``is_key``, ``is_shard`` and ``is_bf16``.
``load_jax_params`` never unpickles: it reads the leaves in that order
(keys sorted: ``convs``, ``fc_h_a``, ``fc_h_v``, ``fc_z_a``, ``fc_z_v``;
the convs in list order, each ``b`` before ``w``; a noisy layer's
``b_mu``, ``b_sigma``, ``w_mu``, ``w_sigma``), turns bfloat16 leaves
(stored as their uint16 bits) into float32, checks every shape against the
architecture, and rebuilds the JAX params dict, which
convert.params_from_jax turns into the port's. A file that does not fit
the architecture raises. Neither source has the IMPALA ResNet: its
params raise, naming it (convert.NO_SOURCE).
"""
from __future__ import annotations

import argparse
import zipfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from rainbow_tpu_torch import checkpoint as ckpt
from rainbow_tpu_torch.convert import (JAX_NOISY_KEYS, params_from_jax,
                                       require_conv_stack, require_source)
from rainbow_tpu_torch.models.dqn import (CONV_STACKS, NOISY_KEYS,
                                          NOISY_LAYERS, param_shapes)

_LEGACY_CONV_REMAP = {  # reference agent.py:29-32
    "conv1.weight": "convs.0.weight", "conv1.bias": "convs.0.bias",
    "conv2.weight": "convs.2.weight", "conv2.bias": "convs.2.bias",
    "conv3.weight": "convs.4.weight", "conv3.bias": "convs.4.bias",
}


def convert_state_dict(state: Dict[str, object]) -> dict:
    """A reference state dict (tensors or arrays) → the port's params: a
    flat dict of contiguous float32 CPU tensors under the same keys.
    Raises on a key that is neither a param nor a noise buffer, and on a
    missing param."""
    sd = {}
    for k, v in state.items():
        k = _LEGACY_CONV_REMAP.get(k, k)
        if k.endswith("_epsilon"):
            continue
        sd[k] = torch.as_tensor(np.asarray(v)).to(torch.float32).contiguous()
    require_conv_stack(sd)
    conv_ids = sorted({int(k.split(".")[1]) for k in sd
                       if k.startswith("convs.")})
    want = [f"convs.{i}.{p}" for i in conv_ids for p in ("weight", "bias")]
    want += [f"{n}.{p}" for n in NOISY_LAYERS for p in NOISY_KEYS]
    missing = [k for k in want if k not in sd]
    extra = sorted(set(sd) - set(want))
    if missing or extra or len(conv_ids) not in {len(a) for a in
                                                  CONV_STACKS.values()}:
        raise ValueError(f"not a reference DQN state dict: missing {missing}, "
                         f"unexpected {extra}, conv layers {conv_ids}")
    return {k: sd[k] for k in want}


def import_torch_model(pth_path: str, out_path: str) -> dict:
    """Convert a reference ``model.pth`` into the port's ``model.npz``
    (checkpoint.save_params) and return the params."""
    state = torch.load(pth_path, map_location="cpu", weights_only=True)
    params = convert_state_dict(state)
    ckpt.save_params(out_path, params)
    return params


def jax_leaf_order(cfg, action_space: int) -> List[Tuple[tuple, str,
                                                        tuple]]:
    """(path in the JAX params dict, the port's key, shape as the JAX
    package stores it) of every params leaf, in the order jax.tree_util's
    flatten gives that dict: keys sorted, the convs in list order. Conv
    weights are HWIO there. The JAX package has only the conv stacks;
    another architecture raises."""
    require_source(cfg.architecture)
    shapes = param_shapes(cfg, action_space)
    order = []
    for i in range(len(CONV_STACKS[cfg.architecture])):
        o, ci, kh, kw = shapes[f"convs.{2 * i}.weight"]
        order += [(("convs", i, "b"), f"convs.{2 * i}.bias", (o,)),
                  (("convs", i, "w"), f"convs.{2 * i}.weight",
                   (kh, kw, ci, o))]
    for name in sorted(NOISY_LAYERS):
        order += [((name, jk), f"{name}.{tk}", shapes[f"{name}.{tk}"])
                  for jk, tk in sorted(JAX_NOISY_KEYS)]
    return order


def is_jax_checkpoint(path: str) -> bool:
    """Whether ``path`` is a file of the JAX package's save_pytree (it has
    a ``treedef`` member), not one of the port's checkpoint.py."""
    with zipfile.ZipFile(path) as z:
        return "treedef.npy" in z.namelist()


def load_jax_params(path: str, cfg, action_space: int,
                    device="cuda") -> dict:
    """The params of a ``model.npz`` written by the JAX package, as the
    port's flat dict of float32 tensors on ``device``, without JAX and
    without unpickling. Raises ValueError if the file's leaf count, flags
    or shapes do not fit the architecture of ``cfg`` with
    ``action_space`` actions."""
    order = jax_leaf_order(cfg, action_space)
    with np.load(path, allow_pickle=False) as z:
        leaves = sorted((m for m in z.files if m.startswith("arr_")),
                        key=lambda m: int(m[4:]))
        if len(leaves) != len(order) or leaves[-1] != f"arr_{len(order) - 1}":
            raise ValueError(f"{path}: {len(leaves)} leaves, the "
                             f"{cfg.architecture} net with {action_space} "
                             f"actions has {len(order)}")
        flags = {f: z[f] for f in ("is_key", "is_bf16") if f in z.files}
        for f, v in flags.items():
            if v.shape != (len(order),):
                raise ValueError(f"{path}: {f} has shape {v.shape}")
        if "is_key" not in flags or flags["is_key"].any():
            raise ValueError(f"{path}: not a params file (PRNG-key leaves, "
                             "or no is_key member)")
        bf16 = flags.get("is_bf16", np.zeros(len(order), bool))
        tree = {"convs": [{} for _ in CONV_STACKS[cfg.architecture]],
                **{name: {} for name in NOISY_LAYERS}}
        for i, (where, key, shape) in enumerate(order):
            a = z[f"arr_{i}"]
            if bf16[i]:
                if a.dtype != np.uint16:
                    raise ValueError(f"{path}: arr_{i} ({key}) is marked "
                                     f"bfloat16 but stored as {a.dtype}")
                a = (a.astype(np.uint32) << 16).view(np.float32)
            if a.shape != shape:
                raise ValueError(f"{path}: arr_{i} ({key}) has shape "
                                 f"{a.shape}, the architecture needs {shape}")
            *up, leaf = where
            node = tree
            for k in up:
                node = node[k]
            node[leaf] = a
    return params_from_jax(tree, device)


def main(argv=None):
    p = argparse.ArgumentParser(description="torch model.pth -> model.npz")
    p.add_argument("pth")
    p.add_argument("out")
    args = p.parse_args(argv)
    params = import_torch_model(args.pth, args.out)
    n = sum(v.numel() for v in params.values())
    print(f"Converted {args.pth} -> {args.out} ({n:,} params)")


if __name__ == "__main__":
    main()
