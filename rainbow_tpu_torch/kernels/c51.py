"""The learner's C51 target and loss as Triton kernels, and their launch
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
latency. Triton is the route because each row's work is a small reduction
over an (A, 64) tile (atoms padded to 64) that fits in registers, with no
matrix-unit work. The target runs one program per row with the row's
51 x 51 triangular weights in registers; the loss runs one program that
walks the batch in row blocks, so the batch mean is summed in a fixed order
(the same bits every run) without a second launch, and writes the loss,
the per-sample losses and both stream gradients in the same launch, so an
update costs one launch here and backward only scales the gradient.

Triton's launcher raises on a launch error. Triton is imported only inside
the launching functions, so this module imports where it is absent.
"""
from __future__ import annotations

import functools

import torch

from rainbow_tpu_torch.kernels import (check_cuda, check_dtype, check_shape,
                                       count_launch)

TARGET = "c51_target"
LOSS = "head_loss"
_BLOCK_ROWS = 32


@functools.cache
def _kernels():
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

    @triton.jit
    def head_loss_kernel(v_ptr, a_ptr, act_ptr, m_ptr, w_ptr, losses_ptr,
                        loss_ptr, dv_ptr, da_ptr, B, A, INV_A, INV_B, ATOMS,
                        BLOCK_R: tl.constexpr, BLOCK_Z: tl.constexpr):
        offs_z = tl.arange(0, BLOCK_Z)
        mask_z = offs_z < ATOMS
        dt = a_ptr.dtype.element_ty
        total = tl.zeros((BLOCK_R,), dtype=tl.float32)
        for r0 in range(0, B, BLOCK_R):
            rows = r0 + tl.arange(0, BLOCK_R)
            mask_r = rows < B
            mask = mask_r[:, None] & mask_z[None, :]
            act = tl.load(act_ptr + rows, mask=mask_r, other=0).to(tl.int32)
            # Σ_k a_k over the actions, for the dueling mean.
            row_a = a_ptr + rows[:, None] * (A * ATOMS) + offs_z[None, :]
            a_sum = tl.zeros((BLOCK_R, BLOCK_Z), dtype=tl.float32)
            for k in range(0, A):
                a_sum += tl.load(row_a + k * ATOMS, mask=mask,
                                 other=0.0).to(tl.float32)
            a_act = tl.load(row_a + act[:, None] * ATOMS, mask=mask,
                            other=0.0).to(tl.float32)
            v = tl.load(v_ptr + rows[:, None] * ATOMS + offs_z[None, :],
                        mask=mask, other=0.0).to(tl.float32)
            # The combine in the streams' dtype, as the dueling-head kernel
            # does it: each op in fp32, rounded to dt; the mean as the fp32
            # sum times 1/A.
            mean = (a_sum * INV_A).to(dt).to(tl.float32)
            q = (v + a_act).to(dt).to(tl.float32)
            q = (q - mean).to(dt).to(tl.float32)
            q = tl.where(mask, q, float("-inf"))
            mx = tl.where(mask_r, tl.max(q, axis=1), 0.0)
            e = tl.exp(q - mx[:, None])
            s = tl.where(mask_r, tl.sum(e, axis=1), 1.0)
            log_p = q - mx[:, None] - tl.log(s)[:, None]
            m = tl.load(m_ptr + rows[:, None] * ATOMS + offs_z[None, :],
                        mask=mask, other=0.0)
            w = tl.load(w_ptr + rows, mask=mask_r, other=0.0)
            losses = -tl.sum(tl.where(mask, m * log_p, 0.0), axis=1)
            tl.store(losses_ptr + rows, losses, mask=mask_r)
            total += tl.where(mask_r, w * losses, 0.0)
            # d mean(w·loss) / d q_{a,j} = (w/B)·(p_j·Σm − m_j).
            p = e / s[:, None]
            g = (w * INV_B)[:, None] * (p * tl.sum(m, axis=1)[:, None] - m)
            tl.store(dv_ptr + rows[:, None] * ATOMS + offs_z[None, :],
                     g.to(dt), mask=mask)
            out_a = da_ptr + rows[:, None] * (A * ATOMS) + offs_z[None, :]
            for k in range(0, A):
                sel = tl.where(act == k, 1.0, 0.0)
                tl.store(out_a + k * ATOMS,
                         (g * (sel[:, None] - INV_A)).to(dt), mask=mask)
        tl.store(loss_ptr, tl.sum(total, axis=0) * INV_B)

    return c51_target_kernel, head_loss_kernel, triton.next_power_of_2


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
    target_kernel, _, next_pow2 = _kernels()
    m = torch.empty((b, atoms), dtype=torch.float32, device=returns.device)
    target_kernel[(b,)](pns_target, a_star, returns, nonterminals, support, m,
                        n_act, atoms, float(discount_n), float(v_min),
                        float(v_max), (v_max - v_min) / (atoms - 1),
                        BLOCK_Z=next_pow2(atoms), num_warps=4)
    count_launch(TARGET)
    return m


def head_loss(v: torch.Tensor, a: torch.Tensor, actions: torch.Tensor,
             m: torch.Tensor, weights: torch.Tensor):
    """(losses (B,), loss (), dv, da); see ops/c51.py::head_loss_plain."""
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
    _, loss_kernel, next_pow2 = _kernels()
    dev = v.device
    losses = torch.empty((b,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    dv = torch.empty_like(v)
    da = torch.empty_like(a)
    loss_kernel[(1,)](v, a, actions, m, weights, losses, loss, dv, da, b,
                      n_act, 1.0 / n_act, 1.0 / b, atoms,
                      BLOCK_R=min(_BLOCK_ROWS, next_pow2(b)),
                      BLOCK_Z=next_pow2(atoms), num_warps=4)
    count_launch(LOSS)
    return losses, loss, dv, da
