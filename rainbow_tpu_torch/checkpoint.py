"""Atomic full-state checkpoints in the port's own format
(rainbow_tpu/checkpoint.py:82-148 covers the same ground for the JAX
package; the two formats are not interchangeable).

A checkpoint is a zip of ``.npy`` members, one per leaf of a nested dict,
under its flat path (``agent/params/fc_h_v.weight_mu``), and one
``__index__`` member: a JSON table of each leaf's kind, stored as uint8
bytes. Nothing is pickled, so loading passes ``allow_pickle=False``.

Leaves are tensors (any device; bfloat16 ones stored as their uint16 bits,
as the JAX package does, checkpoint.py:96-101), numpy arrays, Python
scalars and ``torch.Generator`` s (their ``get_state()``, so the next draw
after a restore is the draw that would have come without one). The file is
written to ``path + ".tmp"`` and renamed over ``path``. Replay-bearing saves
may be deflated (level 1), the analogue of the reference's bz2 pickling
(reference main.py:85-100).
"""
from __future__ import annotations

import json
import os
import zipfile

import numpy as np
import torch
from numpy.lib import format as npformat

from rainbow_tpu_torch.device import resolve_device

_INDEX = "__index__"


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if "/" in k:
            raise ValueError(f"checkpoint keys may not contain '/': {k!r}")
        path = prefix + k
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _encode(leaf) -> tuple:
    """(kind, numpy array) of one leaf."""
    if isinstance(leaf, torch.Generator):
        return f"generator:{leaf.device}", leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bf16", t.view(torch.int16).numpy().view(np.uint16)
        return "tensor", t.numpy()
    if isinstance(leaf, np.ndarray):
        return "ndarray", leaf
    for kind in (bool, int, float):  # bool before int: bool is an int
        if isinstance(leaf, (kind, np.generic)) and \
                isinstance(np.asarray(leaf).item(), kind):
            return kind.__name__, np.asarray(leaf)
    raise TypeError(f"checkpoint: cannot store a {type(leaf).__name__}")


def _decode(kind: str, arr: np.ndarray):
    if kind.startswith("generator:"):
        g = torch.Generator(device=resolve_device(kind.split(":", 1)[1]))
        g.set_state(torch.from_numpy(arr.copy()))
        return g
    if kind == "bf16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if kind == "tensor":
        return torch.from_numpy(arr.copy())
    if kind == "ndarray":
        return arr
    return {"bool": bool, "int": int, "float": float}[kind](arr.item())


def _write(zf: zipfile.ZipFile, name: str, arr: np.ndarray) -> None:
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # not ascontiguousarray: it makes 0-d 1-d
    with zf.open(name + ".npy", "w", force_zip64=True) as f:
        npformat.write_array(f, arr, allow_pickle=False)


def save_state(path: str, tree: dict, compress: bool = False) -> None:
    """Atomically save a nested dict of tensors, arrays, scalars and
    generators."""
    leaves = _flatten(tree)
    index = {}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mode = zipfile.ZIP_DEFLATED if compress else zipfile.ZIP_STORED
    kw = {"compresslevel": 1} if compress else {}
    with zipfile.ZipFile(tmp, "w", mode, allowZip64=True, **kw) as zf:
        for name, leaf in leaves.items():
            kind, arr = _encode(leaf)
            index[name] = kind
            _write(zf, name, arr)
        _write(zf, _INDEX, np.frombuffer(json.dumps(index).encode(),
                                         np.uint8))
    os.replace(tmp, path)


def load_state(path: str) -> dict:
    """Load what save_state wrote: tensors come back on the CPU, generators
    on the device they were saved from."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as z:
        index = json.loads(z[_INDEX].tobytes().decode())
        for name, kind in index.items():
            node = tree
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _decode(kind, z[name])
    return tree


def save_params(path: str, params: dict) -> None:
    """Model-weights-only save (``model.npz``), the analogue of the
    reference's model.pth (agent.py:106-107)."""
    save_state(path, params)


def load_params(path: str, device="cuda") -> dict:
    """The params dict of a ``model.npz``, as tensors on ``device``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)  # reference agent.py:35-36
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in load_state(path).items()}

