"""Launch wrappers of the noisy-linear forward and backward kernels
(csrc/noisy_linear.cu), and their launch plans.

Their plain versions are models/noisy.py::noisy_linear_plain and
noisy_linear_bwd_plain.

A plan is pure arithmetic on the shapes, so the CPU tests check it. The
forward takes the small-batch path (a 16- or 32-row by 64-output block
tile) wherever those tiles alone fill less than one wave of the H100's 132
SMs, and splits the inputs into enough chunks to fill at least one wave,
each short enough (CHUNK_MAX) for a block to stage its x chunk; else the
large-batch path (128 x 128 tiles), split into as many chunks as whole
waves allow (light small-path blocks share an SM, a large-path block has
one to itself). The backward splits dx's reduction over the outputs so
that its dx blocks fill a wave. With more than one chunk the partial sums go
to a scratch tensor that the wrapper allocates for each call on the current
stream, and a second kernel adds them in chunk order: the result has the same
bits on every launch.

A float32 backward with no or shared noise from BWD_LARGE_ROWS batch rows
up takes the large-batch path (``noisy_linear_bwd_large``): two products,
dx = g @ W_eff and dμ_W = gᵀ x, the shared noise folded into W_eff and
into dσ_W = dμ_W ⊙ ε_out ε_inᵀ, on 128 x 128 tiles of both kinds in one
launch. Where those tiles alone leave SMs idle, its plan splits the longer
of the two reductions (the weight tiles' batch, or the dx tiles' outputs)
until they fill a wave or no chunk is longer than BWD_CHUNK_MIN; a second
kernel adds the partial sums in chunk order. BWD_LARGE_ROWS is where the
two backward kernels cross on the H100 (PERF.md).

bfloat16 has a plan of its own (``fwd_plan(..., torch.bfloat16)``): the
same tiles and the same choice of path, for the tensor-core kernels, whose
chunks are multiples of 16 (the MMA's k) and whose small path streams x
through its ring as well, so no chunk is capped at CHUNK_MAX. Its backward
splits dx's reduction as float32's does (``bwd_plan``): 32-row by 64-input
dx tiles, chunks of whole 16-output stages. A bf16 CUDA tensor always
launches the tensor-core kernels; there is no CUDA-core bf16 kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch

from rainbow_tpu_torch.kernels import (build, check_cuda, check_dtype,
                                       check_shape, count_launch)

NAME = "noisy_linear_fwd"
BWD = "noisy_linear_bwd"
BWD_LARGE = "noisy_linear_bwd_large"  # the large path's share of BWD's count
_P, _I = ctypes.c_void_p, ctypes.c_int

WAVE = 132       # SMs of an H100 SXM
KT = 16          # the split's granularity along a reduction
CHUNK_MAX = 256  # the most inputs a float32 small-path block stages at once
# The forward's block tiles, by batch rows: (rows, outputs).
FWD_TILES = {16: (16, 64), 32: (32, 64), 128: (128, 128)}
DX_TILE = (32, 64)  # the backward's dx blocks: (rows, inputs)
BWD_TILE = 128      # the large backward's tiles: 128 x 128, both kinds
BWD_LARGE_ROWS = 128  # float32, no or shared noise: the large backward from
                      # this many batch rows up
BWD_CHUNK_MIN = 128   # the large backward splits no reduction below this


@dataclasses.dataclass(frozen=True)
class Plan:
    path: str     # "small" or "large"
    tile: int     # the block tile's batch rows
    chunk: int    # reduction elements per split: a multiple of KT
    splits: int
    blocks: int   # blocks of the main kernel that the split covers
    scratch: int  # float32 elements of the partial sums; 0 without a split
    # The backward's weight grads reduce over the batch: its rows per split
    # and the splits (the large backward's; the small one walks the whole
    # batch in each weight block). The forward has no such reduction.
    w_chunk: int = 0
    w_splits: int = 1

    def chunks(self, n: int) -> List[Tuple[int, int]]:
        """The [start, end) of each chunk of a reduction of length n, in
        the order the partial sums are added."""
        return _chunks(n, self.chunk, self.splits)

    def batch_chunks(self, b: int) -> List[Tuple[int, int]]:
        """The backward's chunks of the batch for the weight grads."""
        return _chunks(b, self.w_chunk, self.w_splits)


def _chunks(n: int, chunk: int, splits: int) -> List[Tuple[int, int]]:
    return [(s * chunk, min(n, (s + 1) * chunk)) for s in range(splits)]


def _split(n: int, wanted: int, most: int = 1 << 30) -> Tuple[int, int]:
    """(chunk, splits): about ``wanted`` chunks of n, each a multiple of
    KT but the last, none empty, none longer than ``most``."""
    chunk = min(most, KT * math.ceil(math.ceil(n / max(1, wanted)) / KT))
    return chunk, math.ceil(n / chunk)


def fwd_plan(b: int, n_in: int, n_out: int, eps_mode: int,
             dtype: torch.dtype = torch.float32) -> Plan:
    """The forward's launch plan for x (b, n_in) -> (b, n_out) in x's
    ``dtype``."""
    tile = 16 if b <= 16 else 32
    rows, cols = FWD_TILES[tile]
    tiles = math.ceil(b / rows) * math.ceil(n_out / cols)
    if tiles < WAVE:
        path = "small"
        most = CHUNK_MAX if dtype == torch.float32 else n_in
        wanted = math.ceil(WAVE / tiles)
    else:
        path, tile, most = "large", 128, n_in
        rows, cols = FWD_TILES[tile]
        tiles = math.ceil(b / rows) * math.ceil(n_out / cols)
        wanted = max(1, WAVE // tiles)
    chunk, splits = _split(n_in, wanted, most)
    planes = 2 if eps_mode else 1
    return Plan(path, tile, chunk, splits, tiles * splits,
                planes * splits * b * n_out if splits > 1 else 0)


def bwd_plan(b: int, n_in: int, n_out: int, eps_mode: int,
             dtype: torch.dtype = torch.float32) -> Plan:
    """The backward's launch plan for x (b, n_in), g (b, n_out) in x's
    ``dtype``: the large path for float32 with no or shared noise from
    BWD_LARGE_ROWS rows up, else the small path, which splits dx's
    reduction over the outputs (its weight grads reduce over the whole
    batch)."""
    if dtype == torch.float32 and eps_mode < 2 and b >= BWD_LARGE_ROWS:
        return _bwd_large_plan(b, n_in, n_out)
    rows, cols = DX_TILE
    tiles = math.ceil(b / rows) * math.ceil(n_in / cols)
    chunk, splits = _split(n_out, math.ceil(WAVE / tiles))
    planes = 2 if eps_mode else 1
    return Plan("small", rows, chunk, splits, tiles * splits,
                planes * splits * b * n_in if splits > 1 else 0, b, 1)


def _bwd_large_plan(b: int, n_in: int, n_out: int) -> Plan:
    """128 x 128 weight tiles over the batch and dx tiles over the outputs.
    While the pieces fill less than a wave, the reduction whose chunks are
    the longest is cut into one more chunk, down to BWD_CHUNK_MIN."""
    k_tiles = math.ceil(n_in / BWD_TILE)
    w_tiles = math.ceil(n_out / BWD_TILE) * k_tiles
    x_tiles = math.ceil(b / BWD_TILE) * k_tiles
    want_x = want_w = 1
    chunk, splits = _split(n_out, want_x)
    w_chunk, w_splits = _split(b, want_w)
    while (x_tiles * splits + w_tiles * w_splits < WAVE
           and max(chunk, w_chunk) > BWD_CHUNK_MIN):
        if w_chunk >= chunk:
            want_w += 1
            w_chunk, w_splits = _split(b, want_w)
        else:
            want_x += 1
            chunk, splits = _split(n_out, want_x)
    w_part = w_splits * (n_out * n_in + n_out) if w_splits > 1 else 0
    x_part = splits * b * n_in if splits > 1 else 0
    return Plan("large", BWD_TILE, chunk, splits,
                w_tiles * w_splits + x_tiles * splits,
                -(-w_part // 4) * 4 + x_part, w_chunk, w_splits)


@functools.cache
def _lib():
    lib = build.load("noisy_linear")
    fn = lib.noisy_linear_fwd
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P,
                   _I, _I, _I, _P]
    fn.restype = _I
    bwd = lib.noisy_linear_bwd
    bwd.argtypes = [_P, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _P, _I, _I, _P]
    bwd.restype = _I
    large = lib.noisy_linear_bwd_large
    large.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                      _I, _I, _I, _P, _I, _I, _I, _I, _P]
    large.restype = _I
    return lib


def _eps_mode(name, eps, b, n_in, n_out):
    """(mode, eps_in, eps_out): 0 = none, 1 = shared, 2 = per row."""
    if eps is None:
        return 0, None, None
    e_in, e_out = eps
    check_cuda(name, eps_in=e_in, eps_out=e_out)
    check_dtype(name, "eps_in", e_in, torch.float32)
    check_dtype(name, "eps_out", e_out, torch.float32)
    mode = 2 if e_in.dim() == 2 else 1
    lead = (b,) if mode == 2 else ()
    check_shape(name, "eps_in", e_in, lead + (n_in,))
    check_shape(name, "eps_out", e_out, lead + (n_out,))
    return mode, e_in, e_out


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _scratch(plan: Plan, device):
    """The partial sums' scratch for one call, from the caching allocator
    on the current stream (never shared between calls: an asynchronous
    evaluation runs its forwards on a stream of its own)."""
    if not plan.scratch:
        return None
    return torch.empty(plan.scratch, dtype=torch.float32, device=device)


def noisy_linear_fwd(params: dict, x: torch.Tensor,
                     eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     relu: bool = False) -> torch.Tensor:
    """y (B, out) in x's dtype; see models/noisy.py::noisy_linear."""
    w_mu, w_sig = params["weight_mu"], params["weight_sigma"]
    b_mu, b_sig = params["bias_mu"], params["bias_sigma"]
    check_cuda(NAME, x=x, weight_mu=w_mu, weight_sigma=w_sig, bias_mu=b_mu,
               bias_sigma=b_sig)
    check_dtype(NAME, "x", x, torch.float32, torch.bfloat16)
    if x.dim() != 2:
        raise ValueError(f"{NAME}: x must be (B, in), got {tuple(x.shape)}")
    b, n_in = x.shape
    n_out = w_mu.shape[0]
    for arg, t, shape in (("weight_mu", w_mu, (n_out, n_in)),
                          ("weight_sigma", w_sig, (n_out, n_in)),
                          ("bias_mu", b_mu, (n_out,)),
                          ("bias_sigma", b_sig, (n_out,))):
        check_dtype(NAME, arg, t, torch.float32)
        check_shape(NAME, arg, t, shape)
    eps_mode, e_in, e_out = _eps_mode(NAME, eps, b, n_in, n_out)
    plan = fwd_plan(b, n_in, n_out, eps_mode, x.dtype)
    y = torch.empty((b, n_out), dtype=x.dtype, device=x.device)
    scratch = _scratch(plan, x.device)
    err = _lib().noisy_linear_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w_mu.data_ptr(),
        w_sig.data_ptr(), b_mu.data_ptr(), b_sig.data_ptr(), _ptr(e_in),
        _ptr(e_out), eps_mode, y.data_ptr(), b, n_in, n_out, int(relu),
        torch.cuda.current_stream(x.device).cuda_stream, plan.tile,
        plan.chunk, plan.splits, _ptr(scratch))
    if err:
        raise RuntimeError(f"{NAME}: launch failed with CUDA error {err}")
    count_launch(NAME)
    return y


def noisy_linear_bwd(w_mu: torch.Tensor, w_sig: torch.Tensor,
                     x: torch.Tensor, g: torch.Tensor,
                     eps: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     y: Optional[torch.Tensor] = None):
    """(dx, dμ_w, dσ_w, dμ_b, dσ_b) of a noisy linear layer, given its input
    x (B, in), the gradient g (B, out) into its output, and, for a layer
    with a ReLU, its output y (the mask is y > 0). dx has x's dtype, the
    parameter grads are float32. Without eps the σ grads are zeros. See
    models/noisy.py::noisy_linear_bwd_plain."""
    check_cuda(BWD, x=x, g=g, weight_mu=w_mu, weight_sigma=w_sig)
    check_dtype(BWD, "x", x, torch.float32, torch.bfloat16)
    check_dtype(BWD, "g", g, x.dtype)
    if x.dim() != 2:
        raise ValueError(f"{BWD}: x must be (B, in), got {tuple(x.shape)}")
    b, n_in = x.shape
    n_out = w_mu.shape[0]
    for arg, t in (("weight_mu", w_mu), ("weight_sigma", w_sig)):
        check_dtype(BWD, arg, t, torch.float32)
        check_shape(BWD, arg, t, (n_out, n_in))
    check_shape(BWD, "g", g, (b, n_out))
    if y is not None:
        check_cuda(BWD, y=y)
        check_dtype(BWD, "y", y, x.dtype)
        check_shape(BWD, "y", y, (b, n_out))
    eps_mode, e_in, e_out = _eps_mode(BWD, eps, b, n_in, n_out)
    plan = bwd_plan(b, n_in, n_out, eps_mode, x.dtype)
    dev = x.device
    dx = torch.empty_like(x)
    dw_mu = torch.empty((n_out, n_in), dtype=torch.float32, device=dev)
    db_mu = torch.empty((n_out,), dtype=torch.float32, device=dev)
    new = torch.empty if eps_mode else torch.zeros
    dw_sig = new((n_out, n_in), dtype=torch.float32, device=dev)
    db_sig = new((n_out,), dtype=torch.float32, device=dev)
    scratch = _scratch(plan, dev)
    grads = (dx.data_ptr(), dw_mu.data_ptr(), dw_sig.data_ptr(),
             db_mu.data_ptr(), db_sig.data_ptr(), b, n_in, n_out,
             int(y is not None), torch.cuda.current_stream(dev).cuda_stream,
             plan.chunk, plan.splits)
    if plan.path == "large":
        err = _lib().noisy_linear_bwd_large(
            x.data_ptr(), g.data_ptr(), _ptr(y), w_mu.data_ptr(),
            w_sig.data_ptr(), _ptr(e_in), _ptr(e_out), eps_mode, *grads,
            plan.w_chunk, plan.w_splits, _ptr(scratch))
    else:
        err = _lib().noisy_linear_bwd(
            x.data_ptr(), g.data_ptr(), _ptr(y),
            int(x.dtype == torch.bfloat16), w_mu.data_ptr(),
            w_sig.data_ptr(), _ptr(e_in), _ptr(e_out), eps_mode, *grads,
            _ptr(scratch))
    if err:
        raise RuntimeError(f"{BWD}: launch failed with CUDA error {err}")
    count_launch(BWD)
    if plan.path == "large":
        count_launch(BWD_LARGE)
    return dx, dw_mu, dw_sig, db_mu, db_sig
