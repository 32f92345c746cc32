"""The learner's C51 target (a Triton kernel) and loss (csrc/head.cu), and
their launch wrappers.

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

``c51_target`` is Triton: each row's work is a small reduction over a
51 x 51 triangular tile (atoms padded to 64) that fits in registers, with
no matrix-unit work; one program per row. Triton is imported only inside
its launching function, so this module imports where it is absent.

``head_loss`` is CUDA C++ (csrc/head.cu), sharing the dueling combine and
the softmax with the head epilogue: one launch of a thread-block cluster
of up to 8 blocks of 4 rows, one warp per row (rows past 32 loop), lanes
over the atoms (at most 128). It writes the loss, the per-sample losses
and both stream gradients in that launch, so an update costs one launch
here and backward only scales the gradient; the rows' w·loss are added in
row order by one thread, so the scalar has the same bits every run,
without atomics or a second launch.
It is built at first use (build.py) and called through ctypes on the
current stream; a nonzero CUDA error from the launch raises.
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
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _target_kernel():
    # Bound as module globals: Triton resolves the names a kernel uses in
    # its module's globals, not in an enclosing function's scope.
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def c51_target_kernel(p_ptr, act_ptr, ret_ptr, nt_ptr, z_ptr, m_ptr, A,
                          ATOMS, GAMMA_N, V_MIN, V_MAX, DELTA_Z,
                          BLOCK_Z: tl.constexpr):
        row = tl.program_id(0)
        offs = tl.arange(0, BLOCK_Z)
        mask = offs < ATOMS
        a_star = tl.load(act_ptr + row).to(tl.int32)
        p = tl.load(p_ptr + (row * A + a_star) * ATOMS + offs, mask=mask,
                    other=0.0)
        z = tl.load(z_ptr + offs, mask=mask, other=0.0)
        r = tl.load(ret_ptr + row)
        nt = tl.load(nt_ptr + row)
        # The JAX package's op order: R + (nt·γⁿ)·z, clip, (Tz − V_min)/Δz.
        tz = r + (nt * GAMMA_N) * z
        tz = tl.minimum(tl.maximum(tz, V_MIN), V_MAX)
        b = (tz - V_MIN) / DELTA_Z
        # m_j = Σ_i p_i · max(0, 1 − |b_i − j|) over the (i, j) tile.
        j = offs.to(tl.float32)
        w = tl.maximum(1.0 - tl.abs(b[:, None] - j[None, :]), 0.0)
        w = tl.minimum(w, 1.0)
        m = tl.sum(p[:, None] * w, axis=0)
        tl.store(m_ptr + row * ATOMS + offs, m, mask=mask)

    return c51_target_kernel, triton.next_power_of_2


def c51_target(pns_target: torch.Tensor, a_star: torch.Tensor,
               returns: torch.Tensor, nonterminals: torch.Tensor,
               discount_n: float, support: torch.Tensor, v_min: float,
               v_max: float) -> torch.Tensor:
    """m (B, atoms) float32; see ops/c51.py::c51_target."""
    check_cuda(TARGET, pns_target=pns_target, a_star=a_star, returns=returns,
               nonterminals=nonterminals, support=support)
    b, n_act, atoms = pns_target.shape
    check_dtype(TARGET, "pns_target", pns_target, torch.float32)
    check_dtype(TARGET, "a_star", a_star, torch.int64, torch.int32)
    for arg, t in (("returns", returns), ("nonterminals", nonterminals)):
        check_dtype(TARGET, arg, t, torch.float32)
        check_shape(TARGET, arg, t, (b,))
    check_shape(TARGET, "a_star", a_star, (b,))
    check_dtype(TARGET, "support", support, torch.float32)
    check_shape(TARGET, "support", support, (atoms,))
    target_kernel, next_pow2 = _target_kernel()
    m = torch.empty((b, atoms), dtype=torch.float32, device=returns.device)
    target_kernel[(b,)](pns_target, a_star, returns, nonterminals, support, m,
                        n_act, atoms, float(discount_n), float(v_min),
                        float(v_max), (v_max - v_min) / (atoms - 1),
                        BLOCK_Z=next_pow2(atoms), num_warps=4)
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
