"""The dueling C51 head's epilogue: dueling combine, atom softmax, expected
Q, greedy action.

Replaces what XLA fuses for the JAX package after the last noisy layers:
rainbow_tpu/models/dqn.py:148-154 (``q = v + a − mean_a(a)``, an fp32
(log-)softmax over atoms) and the ``Σ z·p`` / argmax / max of
rainbow_tpu/agent.py:99-102, 122-123. On CUDA tensors it is one launch of
the dueling-head kernel (kernels/dueling_head.py), on CPU tensors its plain
version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rainbow_tpu_torch.kernels import dueling_head as kb

DIST_MODES = (None, "probs", "log")


class HeadOut(NamedTuple):
    dist: Optional[torch.Tensor]  # (B, A, atoms) float32 probs or log-probs
    q: torch.Tensor               # (B, A) float32 expected Q, Σ z·p
    action: torch.Tensor          # (B,) int64 greedy action, first max wins
    max_q: torch.Tensor           # (B,) float32


def dueling_head_plain(v: torch.Tensor, a: torch.Tensor,
                       support: torch.Tensor, action_space: int,
                       dist: Optional[str] = None) -> HeadOut:
    """Plain version. v (B, atoms) and a (B, A·atoms) in the compute dtype;
    the combine runs in that dtype and the softmax in float32, as in the
    JAX package."""
    atoms = support.shape[0]
    v = v.reshape(-1, 1, atoms)
    a = a.reshape(-1, action_space, atoms)
    q = (v + a - a.mean(dim=1, keepdim=True)).to(torch.float32)
    probs = torch.softmax(q, dim=2)
    qa = (probs * support).sum(dim=2)
    out = {None: None, "probs": probs,
           "log": torch.log_softmax(q, dim=2) if dist == "log" else None}
    best = qa.max(dim=1)
    return HeadOut(out[dist], qa, qa.argmax(dim=1), best.values)


def dueling_head(v: torch.Tensor, a: torch.Tensor, support: torch.Tensor,
                 action_space: int, dist: Optional[str] = None) -> HeadOut:
    """The head epilogue. ``dist`` is None (q and the greedy action only,
    as acting needs), ``"probs"`` or ``"log"``."""
    if dist not in DIST_MODES:
        raise ValueError(f"dist must be one of {DIST_MODES}, got {dist!r}")
    if v.is_cuda:
        return HeadOut(*kb.dueling_head_fwd(v, a, support, action_space,
                                            dist))
    return dueling_head_plain(v, a, support, action_space, dist)
