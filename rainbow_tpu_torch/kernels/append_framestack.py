"""Launch wrapper of the replay-append + frame-stack kernel
(csrc/append_framestack.cu).

Its plain version is ops/preprocess.py::append_framestack_plain.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch)

NAME = "append_framestack"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    fn = build.load("append_framestack").append_framestack
    fn.argtypes = ([_P, _P, _P, _P, _I, _P, _I, _I, _I]
                   + [_P] * 10 + [_I, _P, _P, _P, _F, _P])
    fn.restype = _I
    return fn


def append_framestack(stack, obs, reset_packed, reset_idx, kinds, rep=None,
                      actions=None, rewards=None, dones=None,
                      reward_clip: float = 0.0) -> None:
    """See ops/preprocess.py::append_framestack_plain. Updates ``stack`` and
    ``rep`` in place: one launch over the envs, and with a replay a
    one-thread launch after it that advances the write head."""
    check_cuda(NAME, stack=stack, obs=obs, reset_packed=reset_packed,
               reset_idx=reset_idx, kinds=kinds)
    if stack.dim() != 4:
        raise ValueError(f"{NAME}: stack must be (N, F, F, H)")
    n, f, _, h = stack.shape
    if h < 2:
        raise ValueError(f"{NAME}: history must be at least 2, got {h}")
    if h == 4 and stack.data_ptr() % 4:
        raise ValueError(f"{NAME}: stack must be 4-byte aligned")
    k = reset_packed.shape[0]
    for arg, t, dtype, shape in (
            ("stack", stack, torch.uint8, (n, f, f, h)),
            ("obs", obs, torch.uint8, (n, f, f)),
            ("reset_packed", reset_packed, torch.uint8, (k, f, f)),
            ("reset_idx", reset_idx, torch.int32, (k,)),
            ("kinds", kinds, torch.uint8, (n,))):
        check_dtype(NAME, arg, t, dtype)
        check_shape(NAME, arg, t, shape)
    replay = [None] * 10
    c = 0
    transition = [None] * 3
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
    err = _lib()(stack.data_ptr(), obs.data_ptr(), reset_packed.data_ptr(),
                 reset_idx.data_ptr(), k, kinds.data_ptr(), n, f * f, h,
                 *replay, c, *transition, float(reward_clip),
                 torch.cuda.current_stream(stack.device).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
