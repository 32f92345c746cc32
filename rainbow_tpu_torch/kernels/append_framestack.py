"""Launch wrapper of the replay-append + frame-stack kernel
(csrc/append_framestack.cu), and its launch plan.

Its plain version is ops/preprocess.py::append_framestack_plain.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch,
                                       device_buffer)

NAME = "append_framestack"
THREADS = 128  # csrc/append_framestack.cu: threads a block
QUADS = 4      # 4-pixel quads a thread on the vector path
CHUNK = 16     # pixels a thread on the byte path
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's grid for N envs of P pixels with history H. The vector
    path (H = 4, P % 4 == 0): one thread per 4 quads of 4 pixels, over the
    flat N·P/4 quads, each warp-wide access contiguous. The byte path: one
    thread per 16 pixels of an env."""
    vector: bool
    items: int    # quads (vector path) or 16-pixel chunks (byte path)
    blocks: int   # blocks of THREADS threads


def launch_plan(n: int, p: int, h: int) -> Plan:
    vector = h == 4 and p % 4 == 0
    items = n * p // 4 if vector else n * -(-p // CHUNK)
    per_block = THREADS * QUADS if vector else THREADS
    return Plan(vector=vector, items=items, blocks=-(-items // per_block))


@functools.cache
def _lib():
    fn = build.load("append_framestack").append_framestack
    fn.argtypes = ([_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I]
                   + [_P] * 10 + [_I, _P, _P, _P, _F, _P, _P])
    fn.restype = _I
    return fn


def append_framestack(stack, obs, reset_packed, reset_idx, kinds, rep=None,
                      actions=None, rewards=None, dones=None,
                      reward_clip: float = 0.0) -> None:
    """See ops/preprocess.py::append_framestack_plain. Updates ``stack`` and
    ``rep`` in place in one launch; with a replay its last block advances
    the write head, through a ticket that the current stream keeps
    (kernels.device_buffer): appends on one stream run one at a time.

    ``reset_idx`` must be sorted ascending, its entries below N distinct and
    the rest N (the padding): the kernel finds an env's reset row by binary
    search. train.pack_resets gives that, and actor_step's arange(N) too.
    On the vector path (H = 4, F·F % 4 == 0) the stack must be 16-byte
    aligned, obs, the reset rows and the ring's frames 4-byte aligned: the
    wrapper raises otherwise.
    """
    check_cuda(NAME, stack=stack, obs=obs, reset_packed=reset_packed,
               reset_idx=reset_idx, kinds=kinds)
    if stack.dim() != 4:
        raise ValueError(f"{NAME}: stack must be (N, F, F, H)")
    n, f, _, h = stack.shape
    if h < 2:
        raise ValueError(f"{NAME}: history must be at least 2, got {h}")
    k = reset_packed.shape[0]
    for arg, t, dtype, shape in (
            ("stack", stack, torch.uint8, (n, f, f, h)),
            ("obs", obs, torch.uint8, (n, f, f)),
            ("reset_packed", reset_packed, torch.uint8, (k, f, f)),
            ("reset_idx", reset_idx, torch.int32, (k,)),
            ("kinds", kinds, torch.uint8, (n,))):
        check_dtype(NAME, arg, t, dtype)
        check_shape(NAME, arg, t, shape)
    plan = launch_plan(n, f * f, h)
    replay = [None] * 10
    c = 0
    transition = [None] * 3
    ticket = None
    aligned = [("stack", stack, 16), ("obs", obs, 4),
               ("reset_packed", reset_packed, 4)]
    if rep is not None:
        c = rep.priorities.shape[1]
        fields = (("frames", rep.frames, torch.uint8, (n, c, f * f)),
                  ("actions", rep.actions, torch.int32, (n, c)),
                  ("rewards", rep.rewards, torch.float32, (n, c)),
                  ("timesteps", rep.timesteps, torch.int32, (n, c)),
                  ("nonterminal", rep.nonterminal, torch.bool, (n, c)),
                  ("priorities", rep.priorities, torch.float32, (n, c)),
                  ("index", rep.index, torch.int32, ()),
                  ("full", rep.full, torch.bool, ()),
                  ("t", rep.t, torch.int32, (n,)),
                  ("max_priority", rep.max_priority, torch.float32, ()),
                  ("prev_actions", actions, torch.int64, (n,)),
                  ("rewards_in", rewards, torch.float32, (n,)),
                  ("dones", dones, torch.bool, (n,)))
        for arg, t, dtype, shape in fields:
            if t is None:
                raise ValueError(f"{NAME}: {arg} is required with a replay")
            check_cuda(NAME, **{arg: t})
            check_dtype(NAME, arg, t, dtype)
            check_shape(NAME, arg, t, shape)
        ptrs = [t.data_ptr() for _, t, _, _ in fields]
        replay, transition = ptrs[:10], ptrs[10:]
        aligned.append(("frames", rep.frames, 4))
        ticket = device_buffer(NAME + " ticket", stack.device, 1,
                               torch.int32).data_ptr()
    if plan.vector:
        for arg, t, align in aligned:
            if t.data_ptr() % align:
                raise ValueError(f"{NAME}: {arg} must be {align}-byte "
                                 "aligned on the vector path (H = 4, "
                                 "F·F % 4 == 0)")
    err = _lib()(stack.data_ptr(), obs.data_ptr(), reset_packed.data_ptr(),
                 reset_idx.data_ptr(), k, kinds.data_ptr(), n, f * f, h,
                 int(plan.vector), plan.blocks, *replay, c, *transition,
                 float(reward_clip), ticket,
                 torch.cuda.current_stream(stack.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
