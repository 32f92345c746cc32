"""Launch wrappers of the replay's sampler and write-back kernels
(csrc/replay.cu): K5 ``stratified_sample``, K6 ``gather_window`` and K7
``write_priorities``.

Their plain versions are replay/prioritized.py's stratified_sample_plain,
gather_window_plain and update_priorities_plain.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch,
                                       device_buffer)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
STEP = 5              # csrc/replay.cu: K5 stores every fifth tree level
MAX_LEAVES = 1 << 22  # K5's scratch is sized for it (heights 5 to 20)
MAX_STORED = 4        # stored heights at MAX_LEAVES
MAX_WINDOW = 64       # csrc/replay.cu: the blanking mask is one uint64
WRITE_THREADS = 256   # csrc/replay.cu: K7's threads a block, one a draw
GATHER_WARPS = 8      # csrc/replay.cu: K6's warps a block, of either kind


@functools.cache
def _lib():
    lib = build.load("replay")
    lib.stratified_sample.argtypes = [_P, _P, _I, _I, _I, _I, _P, _I, _I, _I,
                                      ctypes.POINTER(_I)] + [_P] * 6
    lib.gather_window.argtypes = ([_P] * 7 + [_I, _I, _I] + [_P] * 3
                                  + [_I, _I, _F, _F, _I, _I, _I] + [_P] * 8)
    lib.write_priorities.argtypes = [_P, _P, _I, _I, _F, _I, _P, _P, _P]
    for fn in (lib.stratified_sample, lib.gather_window,
               lib.write_priorities):
        fn.restype = _I
    return lib


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_ring(name: str, state) -> tuple:
    e, c = state.priorities.shape
    for arg, t, dtype, shape in (
            ("priorities", state.priorities, torch.float32, (e, c)),
            ("index", state.index, torch.int32, ())):
        check_cuda(name, **{arg: t})
        check_dtype(name, arg, t, dtype)
        check_shape(name, arg, t, shape)
    return e, c


@dataclasses.dataclass(frozen=True)
class TreePlan:
    """K5's tree over ``leaves`` = 2^depth (the leaf count padded to a power
    of two): the stored levels are the heights in ``heights`` (every fifth
    below the root, never the leaves), height heights[k] at offsets[k] of
    the scratch; the descent's first step takes ``first_step`` levels from
    the root and every other step five; ``launches`` is 2 with a stored
    level to build, else 1."""
    leaves: int
    depth: int
    heights: tuple
    offsets: tuple
    scratch: int
    first_step: int
    launches: int


def tree_plan(n: int) -> TreePlan:
    """K5's plan for ``n`` leaves: the depth, stored levels and offsets the
    kernels run with (csrc/replay.cu::stratified_sample checks them)."""
    depth = (n - 1).bit_length()
    leaves = 1 << depth
    heights = tuple(range(STEP, depth, STEP))
    sizes = [leaves >> h for h in heights]
    offsets = tuple(sum(sizes[:k]) for k in range(len(sizes)))
    return TreePlan(leaves=leaves, depth=depth, heights=heights,
                    offsets=offsets, scratch=sum(sizes),
                    first_step=depth - STEP * len(heights),
                    launches=2 if heights else 1)


SCRATCH = tree_plan(MAX_LEAVES).scratch  # floats, one scratch per stream


def stratified_sample(state, u: torch.Tensor, history: int, n_step: int):
    """K5: one stratified draw per entry of ``u`` (B,) float32 in [0, 1)
    over the ring's priorities masked around the write head. Returns (leaf
    indices (B,) int64, their priorities (B,) float32, the total 0-d
    float32), the bits of prioritized.py::stratified_sample_plain. Two
    launches on the current stream (one with at most 32 leaves: tree_plan);
    the stored tree levels and the build's ticket live in the current
    stream's buffers (kernels.device_buffer), so a call allocates only its
    three outputs, and calls on one stream run one at a time. The
    priorities must be 16-byte aligned."""
    name = "stratified_sample"
    e, c = _check_ring(name, state)
    check_cuda(name, u=u)
    check_dtype(name, "u", u, torch.float32)
    if u.dim() != 1 or u.numel() < 1:
        raise ValueError(f"{name}: u must be a nonempty (B,) tensor")
    n = e * c
    if n > MAX_LEAVES:
        raise ValueError(f"{name}: {n} leaves exceed the kernel's "
                         f"{MAX_LEAVES}")
    if state.priorities.data_ptr() % 16:
        raise ValueError(f"{name}: priorities must be 16-byte aligned (the "
                         "build reads four leaves at a time)")
    b = u.shape[0]
    plan = tree_plan(n)
    dev = u.device
    levels = device_buffer(name + " levels", dev, SCRATCH, torch.float32)
    ticket = device_buffer(name + " ticket", dev, 1, torch.int32)
    idx = torch.empty(b, dtype=torch.int64, device=dev)
    p = torch.empty(b, dtype=torch.float32, device=dev)
    total = torch.empty((), dtype=torch.float32, device=dev)
    offsets = (_I * MAX_STORED)(*plan.offsets)
    _raise_on(name, _lib().stratified_sample(
        state.priorities.data_ptr(), state.index.data_ptr(), e, c, history,
        n_step, u.data_ptr(), b, plan.depth, len(plan.heights), offsets,
        levels.data_ptr(), ticket.data_ptr(), idx.data_ptr(), p.data_ptr(),
        total.data_ptr(), _stream(u)))
    count_launch(name)
    return idx, p, total


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """K6's one launch for nb batches of bs rows and a window of w frames:
    ``field_blocks`` (one a batch, first in the grid), each with a warp a
    row and ``rows_a_warp`` rows for its busiest warp; ``copy_warps``, one
    a window frame, in ``copy_blocks`` of GATHER_WARPS; ``blocks`` in all,
    of GATHER_WARPS warps each."""
    field_blocks: int
    rows_a_warp: int
    copy_warps: int
    copy_blocks: int
    blocks: int


def gather_plan(num_batches: int, batch_size: int, window: int) -> GatherPlan:
    """K6's launch plan (csrc/replay.cu::gather_window checks its block
    count)."""
    copy_warps = num_batches * batch_size * window
    copy_blocks = -(-copy_warps // GATHER_WARPS)
    return GatherPlan(field_blocks=num_batches,
                      rows_a_warp=-(-batch_size // GATHER_WARPS),
                      copy_warps=copy_warps, copy_blocks=copy_blocks,
                      blocks=num_batches + copy_blocks)


def gather_window(state, idx: torch.Tensor, p: torch.Tensor,
                  total: torch.Tensor, beta: float, num_batches: int,
                  batch_size: int, history: int, n_step: int,
                  discount: float) -> dict:
    """K6: the round's batches from K5's draws (``idx``, ``p`` in draw
    order, ``total``): draw j goes to batch j % num_batches, row
    j // num_batches. Returns the dict of prioritized.py::gather_window_plain
    (``idxs``, uint8 ``states`` and ``next_states`` as permuted views of one
    (nb, bs, history + n_step, F·F) window, ``actions``, ``returns``,
    ``nonterminals``, ``weights`` normalised per batch, ``weights_max``).
    One launch on the current stream under gather_plan."""
    name = "gather_window"
    e, c = _check_ring(name, state)
    nb, bs = num_batches, batch_size
    b, w = nb * bs, history + n_step
    if w > MAX_WINDOW:
        raise ValueError(f"{name}: a window of {w} frames exceeds "
                         f"{MAX_WINDOW}")
    fp = state.frames.shape[2]
    for arg, t, dtype, shape in (
            ("frames", state.frames, torch.uint8, (e, c, fp)),
            ("actions", state.actions, torch.int32, (e, c)),
            ("rewards", state.rewards, torch.float32, (e, c)),
            ("timesteps", state.timesteps, torch.int32, (e, c)),
            ("nonterminal", state.nonterminal, torch.bool, (e, c)),
            ("full", state.full, torch.bool, ()),
            ("idx", idx, torch.int64, (b,)),
            ("p", p, torch.float32, (b,)),
            ("total", total, torch.float32, ())):
        check_cuda(name, **{arg: t})
        check_dtype(name, arg, t, dtype)
        check_shape(name, arg, t, shape)
    dev = idx.device
    f32 = dict(dtype=torch.float32, device=dev)
    out_idx = torch.empty((nb, bs), dtype=torch.int64, device=dev)
    actions = torch.empty((nb, bs), dtype=torch.int32, device=dev)
    returns = torch.empty((nb, bs), **f32)
    nonterminals = torch.empty((nb, bs), **f32)
    weights = torch.empty((nb, bs), **f32)
    wmax = torch.empty((nb,), **f32)
    window = torch.empty((nb, bs, w, fp), dtype=torch.uint8, device=dev)
    _raise_on(name, _lib().gather_window(
        state.frames.data_ptr(), state.actions.data_ptr(),
        state.rewards.data_ptr(), state.timesteps.data_ptr(),
        state.nonterminal.data_ptr(), state.index.data_ptr(),
        state.full.data_ptr(), e, c, fp, idx.data_ptr(), p.data_ptr(),
        total.data_ptr(), history, n_step, float(discount), float(beta), nb,
        bs, gather_plan(nb, bs, w).blocks, out_idx.data_ptr(),
        actions.data_ptr(), returns.data_ptr(), nonterminals.data_ptr(),
        weights.data_ptr(), wmax.data_ptr(), window.data_ptr(), _stream(idx)))
    count_launch(name)
    return window_fields(window, history, n_step, {
        "idxs": out_idx, "actions": actions, "returns": returns,
        "nonterminals": nonterminals, "weights": weights,
        "weights_max": wmax})


def window_fields(window: torch.Tensor, history: int, n_step: int,
                  fields: dict) -> dict:
    """``fields`` with ``states`` (frames 0..history-1) and ``next_states``
    (frames n_step..n_step+history-1) added as (nb, bs, F, F, history)
    permuted views of the (nb, bs, history + n_step, F·F) ``window``."""
    nb, bs, w, fp = window.shape
    f = int(round(fp ** 0.5))
    fr = window.view(nb, bs, w, f, f)
    return dict(fields,
                states=fr[:, :, :history].permute(0, 1, 3, 4, 2),
                next_states=fr[:, :, n_step:n_step + history]
                .permute(0, 1, 3, 4, 2))


def write_blocks(draws: int) -> int:
    """K7's grid for ``draws`` draws: one thread a draw, WRITE_THREADS a
    block (csrc/replay.cu::write_priorities checks it)."""
    return -(-draws // WRITE_THREADS)


def write_priorities(state, idxs: torch.Tensor, losses: torch.Tensor,
                     priority_exponent: float) -> None:
    """K7: ``priorities[idxs] = losses ** priority_exponent`` and
    ``max_priority = max(max_priority, max of those)``, in place, in one
    launch of write_blocks(B) blocks. ``idxs`` and ``losses`` are (nb, bs)
    in batch order, as gather_window returns them (element [k, r] is draw
    r·nb + k), or (B,) in draw order. Where consecutive draws hit one leaf,
    the last of them is written; a leaf repeated by draws that are not
    consecutive gets one of its values. A NaN priority makes max_priority
    NaN, as torch.maximum does."""
    name = "write_priorities"
    e, c = state.priorities.shape
    if idxs.dim() == 1:
        idxs, losses = idxs.view(1, -1), losses.view(1, -1)
    if idxs.dim() != 2 or idxs.numel() < 1:
        raise ValueError(f"{name}: idxs must be a nonempty (nb, bs) or (B,) "
                         "tensor")
    nb, bs = idxs.shape
    for arg, t, dtype, shape in (
            ("priorities", state.priorities, torch.float32, (e, c)),
            ("max_priority", state.max_priority, torch.float32, ()),
            ("idxs", idxs, torch.int64, (nb, bs)),
            ("losses", losses, torch.float32, (nb, bs))):
        check_cuda(name, **{arg: t})
        check_dtype(name, arg, t, dtype)
        check_shape(name, arg, t, shape)
    _raise_on(name, _lib().write_priorities(
        idxs.data_ptr(), losses.data_ptr(), nb, bs, float(priority_exponent),
        write_blocks(nb * bs), state.priorities.data_ptr(),
        state.max_priority.data_ptr(), _stream(idxs)))
    count_launch(name)
