"""The dueling C51 head epilogue as a Triton kernel, and its launch wrapper.

Replaces what XLA fuses for the JAX package at rainbow_tpu/models/dqn.py:
148-154 (dueling combine q = v + a − mean_a(a) in the streams' dtype, fp32
(log-)softmax over the atoms) and rainbow_tpu/agent.py:99-102, 122-123 (Σ z·p, argmax, max); with
the noisy-linear kernel it does the forward work of the deleted Pallas
kernel fused_dueling_head. Triton is the route here because the work is a
softmax over 51 atoms followed by two small reductions over the actions,
the case Triton is made for. Its plain version is ops/head.py::
dueling_head_plain.

Bound on the H100 at the actor's shapes (B = 1024, A = 6, 51 atoms): about
1.5 MB moved (v, a, q, argmax, max q; 14 MB more when the (B, A, 51)
distribution is written) against a few MFLOP, so it is bound by bytes and,
at this size, by launch latency. The design is one program per batch row
that keeps the row's (A, 64) block of logits in registers (atoms padded to
64 and masked), so nothing but the outputs asked for is written: acting
asks for the greedy action and q only.

Triton's launcher checks what cuLaunchKernel returns and raises on an
error. It is imported only inside the launching function, so this module
imports where Triton is absent.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from rainbow_tpu_torch.kernels import (check_cuda, check_dtype, check_shape,
                                       count_launch)

NAME = "dueling_head"


@functools.cache
def _kernel():
    # Bound as module globals: Triton resolves the names a kernel uses in
    # its module's globals, not in an enclosing function's scope.
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def dueling_head_kernel(v_ptr, a_ptr, z_ptr, dist_ptr, q_ptr, act_ptr,
                            maxq_ptr, A, INV_A, ATOMS,
                            BLOCK_A: tl.constexpr, BLOCK_Z: tl.constexpr,
                            WRITE_DIST: tl.constexpr, LOG: tl.constexpr):
        row = tl.program_id(0)
        offs_a = tl.arange(0, BLOCK_A)
        offs_z = tl.arange(0, BLOCK_Z)
        mask_a = offs_a < A
        mask_z = offs_z < ATOMS
        mask = mask_a[:, None] & mask_z[None, :]
        tile = offs_a[:, None] * ATOMS + offs_z[None, :]
        # The combine runs in the streams' dtype: each op computes in fp32
        # and rounds to that dtype, as PyTorch and the JAX package do; only
        # the softmax and what follows stay in fp32.
        dt = a_ptr.dtype.element_ty
        a = tl.load(a_ptr + row * A * ATOMS + tile, mask=mask,
                    other=0.0).to(tl.float32)
        v = tl.load(v_ptr + row * ATOMS + offs_z, mask=mask_z,
                    other=0.0).to(tl.float32)
        z = tl.load(z_ptr + offs_z, mask=mask_z, other=0.0)
        # The mean is the sum times 1/A rounded to fp32, as PyTorch's CUDA
        # mean computes it, so the rounding to dt lands on the same value.
        mean = (tl.sum(a, axis=0) * INV_A).to(dt).to(tl.float32)
        q = (v[None, :] + a).to(dt).to(tl.float32)
        q = (q - mean[None, :]).to(dt).to(tl.float32)
        q = tl.where(mask, q, float("-inf"))
        m = tl.where(mask_a, tl.max(q, axis=1), 0.0)
        e = tl.exp(q - m[:, None])
        s = tl.where(mask_a, tl.sum(e, axis=1), 1.0)
        p = e / s[:, None]
        if WRITE_DIST:
            if LOG:
                out = q - m[:, None] - tl.log(s)[:, None]
            else:
                out = p
            tl.store(dist_ptr + row * A * ATOMS + tile, out, mask=mask)
        qa = tl.sum(p * z[None, :], axis=1)
        tl.store(q_ptr + row * A + offs_a, qa, mask=mask_a)
        qa = tl.where(mask_a, qa, float("-inf"))
        best = tl.max(qa, axis=0)
        first = tl.min(tl.where(qa == best, offs_a, BLOCK_A), axis=0)
        tl.store(act_ptr + row, first.to(tl.int64))
        tl.store(maxq_ptr + row, best)

    return dueling_head_kernel, triton.next_power_of_2


def dueling_head_fwd(v: torch.Tensor, a: torch.Tensor, support: torch.Tensor,
                     action_space: int, dist: Optional[str] = None):
    """(dist or None, q (B, A), action (B,) int64, max q (B,)); see
    ops/head.py::dueling_head."""
    check_cuda(NAME, v=v, a=a, support=support)
    check_dtype(NAME, "v", v, torch.float32, torch.bfloat16)
    check_dtype(NAME, "a", a, v.dtype)
    check_dtype(NAME, "support", support, torch.float32)
    atoms = support.shape[0]
    b = v.shape[0]
    check_shape(NAME, "v", v, (b, atoms))
    check_shape(NAME, "a", a, (b, action_space * atoms))
    kernel, next_pow2 = _kernel()
    dev = v.device
    q = torch.empty((b, action_space), dtype=torch.float32, device=dev)
    act = torch.empty((b,), dtype=torch.int64, device=dev)
    max_q = torch.empty((b,), dtype=torch.float32, device=dev)
    out = (torch.empty((b, action_space, atoms), dtype=torch.float32,
                       device=dev) if dist else None)
    kernel[(b,)](v, a, support, out if out is not None else q, q, act, max_q,
                 action_space, 1.0 / action_space, atoms, BLOCK_A=next_pow2(action_space),
                 BLOCK_Z=next_pow2(atoms), WRITE_DIST=dist is not None,
                 LOG=dist == "log", num_warps=2)
    count_launch(NAME)
    return out, q, act, max_q
