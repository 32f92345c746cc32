"""The learner's C51 target and loss (csrc/head.cu), and their launch
wrappers.

Replaces what XLA fuses for the JAX package in the learner's update:

- ``c51_target``: the gather of the target net's distribution at the
  double-Q action a* (rainbow_tpu/agent.py:198-199) and the projection
  onto the support (rainbow_tpu/ops/c51.py:28-54).
- ``head_loss``: the dueling combine in the streams' dtype, the fp32
  log-softmax over atoms, the gather at the taken action
  (agent.py:128-132), −Σ m·log p (c51.py:57-59) and mean(w·loss)
  (agent.py:134), together with the gradient of that mean into the value
  and advantage streams. With the backward of the noisy-linear kernel this
  is the backward work of the deleted Pallas kernel fused_dueling_head.

Their plain versions are ops/c51.py::c51_target_plain and head_loss_plain.

Bound on the H100 at the learner's shapes (B = 32, A = 6, 51 atoms): under
1 MB moved and a few MFLOP per call, so each call is bound by launch
latency.

Both are CUDA C++ in csrc/head.cu, beside the head epilogue (KB), one warp
per row with lanes over the atoms (at most dueling_head.MAX_ATOMS; the
wrappers raise above it).

``c51_target`` runs 4 rows a block and keeps the dense triangular form
m_j = Σ_i p_i·clamp(1 − |b_i − j|, 0, 1): each lane computes p_i and b_i
of its source atoms, then the source atoms are broadcast in order by warp
shuffles and every lane adds to its target atoms, so a row sums in atom
order with the same bits every launch.

``head_loss`` shares the dueling combine and the softmax with the head
epilogue: one launch of a thread-block cluster of up to 8 blocks of 4
rows (rows past 32 loop). It writes the loss, the per-sample losses and
both stream gradients in that launch, so an update costs one launch here
and backward only scales the gradient; the rows' w·loss are added in row
order by one thread, so the scalar has the same bits every run, without
atomics or a second launch.

The source is built at first use (build.py) and called through ctypes on
the current stream; a nonzero CUDA error from a launch raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch)
from rainbow_tpu_torch.kernels.dueling_head import check_atoms

TARGET = "c51_target"
LOSS = "head_loss"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _target_lib():
    fn = build.load("head").c51_target
    fn.argtypes = [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                   _P]
    fn.restype = _I
    return fn


def c51_target(pns_target: torch.Tensor, a_star: torch.Tensor,
               returns: torch.Tensor, nonterminals: torch.Tensor,
               discount_n: float, support: torch.Tensor, v_min: float,
               v_max: float) -> torch.Tensor:
    """m (B, atoms) float32; see ops/c51.py::c51_target. At most
    dueling_head.MAX_ATOMS atoms."""
    check_atoms(TARGET, support.shape[0])
    check_cuda(TARGET, pns_target=pns_target, a_star=a_star, returns=returns,
               nonterminals=nonterminals, support=support)
    check_dtype(TARGET, "pns_target", pns_target, torch.float32)
    b, n_act, atoms = pns_target.shape
    check_dtype(TARGET, "a_star", a_star, torch.int64, torch.int32)
    for arg, t in (("returns", returns), ("nonterminals", nonterminals)):
        check_dtype(TARGET, arg, t, torch.float32)
        check_shape(TARGET, arg, t, (b,))
    check_shape(TARGET, "a_star", a_star, (b,))
    check_dtype(TARGET, "support", support, torch.float32)
    check_shape(TARGET, "support", support, (atoms,))
    if b < 1 or n_act < 1:
        raise ValueError(f"{TARGET}: empty batch or action space ({b}, "
                         f"{n_act})")
    m = torch.empty((b, atoms), dtype=torch.float32, device=returns.device)
    err = _target_lib()(pns_target.data_ptr(), a_star.data_ptr(),
                        int(a_star.dtype == torch.int64), returns.data_ptr(),
                        nonterminals.data_ptr(), support.data_ptr(),
                        m.data_ptr(), b, n_act, atoms, discount_n, v_min,
                        v_max, (v_max - v_min) / (atoms - 1),
                        torch.cuda.current_stream(m.device).cuda_stream)
    if err:
        raise RuntimeError(f"{TARGET}: launch failed with CUDA error {err}")
    count_launch(TARGET)
    return m


@functools.cache
def _loss_lib():
    fn = build.load("head").head_loss
    fn.argtypes = [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                   _P]
    fn.restype = _I
    return fn


def head_loss(v: torch.Tensor, a: torch.Tensor, actions: torch.Tensor,
             m: torch.Tensor, weights: torch.Tensor):
    """(losses (B,), loss (), dv, da); see ops/c51.py::head_loss_plain.
    At most dueling_head.MAX_ATOMS atoms."""
    check_atoms(LOSS, v.shape[-1])
    check_cuda(LOSS, v=v, a=a, actions=actions, m=m, weights=weights)
    check_dtype(LOSS, "v", v, torch.float32, torch.bfloat16)
    check_dtype(LOSS, "a", a, v.dtype)
    check_dtype(LOSS, "actions", actions, torch.int64, torch.int32)
    b, atoms = v.shape
    if a.dim() != 2 or a.shape[0] != b or a.shape[1] % atoms:
        raise ValueError(f"{LOSS}: a must be (B, A·{atoms}), got "
                         f"{tuple(a.shape)}")
    n_act = a.shape[1] // atoms
    check_shape(LOSS, "actions", actions, (b,))
    check_dtype(LOSS, "m", m, torch.float32)
    check_shape(LOSS, "m", m, (b, atoms))
    check_dtype(LOSS, "weights", weights, torch.float32)
    check_shape(LOSS, "weights", weights, (b,))
    if b < 1 or n_act < 1:
        raise ValueError(f"{LOSS}: empty batch or action space ({b}, "
                         f"{n_act})")
    dev = v.device
    losses = torch.empty((b,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    dv = torch.empty_like(v)
    da = torch.empty_like(a)
    err = _loss_lib()(v.data_ptr(), a.data_ptr(),
                      int(v.dtype == torch.bfloat16), actions.data_ptr(),
                      int(actions.dtype == torch.int64), m.data_ptr(),
                      weights.data_ptr(), losses.data_ptr(), loss.data_ptr(),
                      dv.data_ptr(), da.data_ptr(), b, n_act, atoms,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{LOSS}: launch failed with CUDA error {err}")
    count_launch(LOSS)
    return losses, loss, dv, da
