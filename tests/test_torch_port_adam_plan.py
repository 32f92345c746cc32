"""The design of the clip + Adam kernel (K9, kernels/adam.py and
csrc/adam.cu), held on the CPU where no card is:

- adam_plan: pass 1's chunks of 4096 elements a tensor, pass 2's chunks
  of 1024 (four elements a thread), and the per-tensor mask of the arrays whose pointers allow four elements
  a step, from views of one flat buffer at offsets 0, 51, 357 and 1,023 (as
  the data-parallel round hands the kernel its gradients) and from separate
  tensors;
- a rendering of both passes' maps from (block, thread) to elements: every
  element once, pass 1 in the order of the kernel's first design (thread t
  of a chunk its elements t + 256 i), pass 2 in quads, blocks in reverse;
- the ctypes table against the C struct, and the source's exports against
  what the wrapper binds.

Integer work only: exact.
"""
import ctypes
import math
import re
import types
from pathlib import Path

import pytest
import torch

from rainbow_tpu_torch import canonical
from rainbow_tpu_torch.cli import parse_config
from rainbow_tpu_torch.kernels import adam as k9
from rainbow_tpu_torch.kernels import build
from rainbow_tpu_torch.kernels.adam import (SUM_CHUNK, THREADS,
                                            UPDATE_CHUNK, VEC_BITS, adam_plan)
from rainbow_tpu_torch.models import dqn

ROOT = Path(__file__).resolve().parents[1]
P_BIT, G_BIT, MU_BIT, NU_BIT = VEC_BITS


def _net_numels(preset):
    cfg = (canonical(game="pong", num_envs=1024, seed=0) if preset is None
           else parse_config(["--preset", preset])[0])
    return [math.prod(s) for s in dqn.param_shapes(cfg, 6).values()]


def _tensors(numels, layout, mu_dtype):
    """p, g, mu, nu lists: separate tensors, or each kind as views of one
    flat buffer at the running offsets."""
    def kind(dtype):
        if layout == "separate":
            return [torch.zeros(n, dtype=dtype) for n in numels]
        flat = torch.zeros(sum(numels), dtype=dtype)
        assert flat.data_ptr() % 64 == 0
        offsets = [sum(numels[:i]) for i in range(len(numels))]
        return [flat[o:o + n] for o, n in zip(offsets, numels)]
    return (kind(torch.float32), kind(torch.float32), kind(mu_dtype),
            kind(torch.float32))


def _plan(numels, tensors):
    pointers = [tuple(t.data_ptr() for t in ts) for ts in zip(*tensors)]
    return adam_plan(numels, pointers, tensors[2][0].element_size())


# Views at offsets 0, 51, 357 and 1,023 of one flat buffer.
UNALIGNED = [51, 306, 666, 1000]


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_vec_mask_follows_each_pointer(mu_dtype):
    """Views at odd offsets access their arrays one element at a time, the
    view at offset 0 and separate tensors four at a time; with every kind
    as views, only the first tensor is aligned in any of them."""
    numels = UNALIGNED
    assert [sum(numels[:i]) for i in range(4)] == [0, 51, 357, 1023]
    p, _, mu, nu = _tensors(numels, "separate", mu_dtype)
    _, g, _, _ = _tensors(numels, "flat", mu_dtype)
    plan = _plan(numels, (p, g, mu, nu))
    every = P_BIT | G_BIT | MU_BIT | NU_BIT
    assert plan.vec == (every,) + (every & ~G_BIT,) * 3
    plan = _plan(numels, _tensors(numels, "flat", mu_dtype))
    assert plan.vec == (every, 0, 0, 0)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_vec_mask_on_offsets_of_four(mu_dtype):
    """At offsets that are multiples of four elements a float32 view is
    16-byte aligned and a bf16 one 8-byte aligned: every array takes four
    elements a step."""
    numels = [4, 8, 1028, 3]
    plan = _plan(numels, _tensors(numels, "flat", mu_dtype))
    assert plan.vec[:4] == (15, 15, 15, 15)
    bumped = torch.zeros(10, dtype=mu_dtype)[2:6]  # 4 or 8 bytes past
    assert adam_plan([4], [(0, 0, bumped.data_ptr(), 0)],
                     bumped.element_size()).vec == (P_BIT | G_BIT | NU_BIT,)


@pytest.mark.parametrize("preset", [None, "data-efficient", "throughput"])
def test_chunk_tables_at_the_presets(preset):
    """Pass 1 cuts every tensor into chunks of 4096 as the kernel's first
    design did (1,690 at the canonical net, 216 at the data-efficient
    one); pass 2 into chunks of 1024, four elements a thread (6,717 and
    820 blocks: several waves of the 132 SMs at either net)."""
    numels = _net_numels(preset)
    plan = _plan(numels, _tensors(numels, "separate", torch.float32))
    assert UPDATE_CHUNK == 4 * THREADS
    for starts, size in ((plan.sum_start, SUM_CHUNK),
                         (plan.update_start, UPDATE_CHUNK)):
        assert starts[0] == 0 and len(starts) == len(numels) + 1
        assert [b - a for a, b in zip(starts, starts[1:])] == \
            [-(-n // size) for n in numels]
    total, blocks = {None: (6_868_842, (1690, 6717)),
                     "throughput": (6_868_842, (1690, 6717)),
                     "data-efficient": (828_842, (216, 820))}[preset]
    assert sum(numels) == total
    assert (plan.sum_start[-1], plan.update_start[-1]) == blocks
    assert min(blocks) > 132
    # L2 keeps the data-efficient net's 3.3 MB of grads between the passes,
    # not the canonical net's 27.5 MB.
    assert plan.keep_g == (preset == "data-efficient")


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_one_call_takes_the_impala_net(mu_dtype):
    """The IMPALA ResNet x4 net's 46 tensors (33,639,946 parameters at
    pong's 6 actions) fit one table, under one global norm: 8,238 chunks of
    pass 1 and 32,872 of pass 2, every tensor aligned; its 134.6 MB of
    grads are past L2's keep. The table of 64 entries stays inside the
    4 KB of a kernel's arguments; a 65th tensor is refused."""
    cfg = canonical(game="pong", num_envs=1024, seed=0,
                    architecture="impala-x4")
    numels = [math.prod(s) for s in dqn.param_shapes(cfg, 6).values()]
    assert len(numels) == 46 <= k9.MAX_TENSORS == 64
    plan = _plan(numels, _tensors(numels, "separate", mu_dtype))
    for starts, size in ((plan.sum_start, SUM_CHUNK),
                         (plan.update_start, UPDATE_CHUNK)):
        assert [b - a for a, b in zip(starts, starts[1:])] == \
            [-(-n // size) for n in numels]
    assert sum(numels) == 33_639_946
    assert (plan.sum_start[-1], plan.update_start[-1]) == (8_238, 32_872)
    assert plan.vec == (P_BIT | G_BIT | MU_BIT | NU_BIT,) * 46
    assert not plan.keep_g
    assert ctypes.sizeof(k9._Table) + 8 + 8 + 7 * 4 <= 4096
    t = [torch.zeros(1)] * (k9.MAX_TENSORS + 1)
    with pytest.raises(ValueError, match="needs 1 to 64 tensors"):
        k9.clip_adam(t, t, t, t, torch.zeros((), dtype=torch.int32), 1e-3,
                     0.9, 0.999, 1e-8, 10.0)


def _pass1_elements(plan, numels):
    """(tensor, element) of each (block, thread, i) of pass 1, in the
    order thread t of a block sums them."""
    out = {}
    for blk in range(plan.sum_start[-1]):
        k = max(i for i in range(len(numels)) if plan.sum_start[i] <= blk)
        start = (blk - plan.sum_start[k]) * SUM_CHUNK
        for t in range(THREADS):
            out[blk, t] = [(k, e) for e in range(start + t,
                                                 start + SUM_CHUNK, THREADS)
                           if e < numels[k]]
    return out


def _pass2_elements(plan, numels):
    """(tensor, element) of each block of pass 2: block b takes chunk
    blocks - 1 - b, thread t its elements 4t .. 4t + 3."""
    blocks = plan.update_start[-1]
    out = []
    for b in range(blocks):
        blk = blocks - 1 - b
        k = max(i for i in range(len(numels)) if plan.update_start[i] <= blk)
        base = (blk - plan.update_start[k]) * UPDATE_CHUNK
        for t in range(THREADS):
            out += [(k, e) for e in range(base + 4 * t, base + 4 * t + 4)
                    if e < numels[k]]
    return out


@pytest.mark.parametrize("numels", [[1], [3, 4097, 51], UNALIGNED,
                                    [4096, 1, 8193], [70 * 301, 70, 5000]])
def test_both_passes_cover_every_element_once(numels):
    plan = _plan(numels, _tensors(numels, "flat", torch.float32))
    every = sorted((k, e) for k, n in enumerate(numels) for e in range(n))
    p1 = _pass1_elements(plan, numels)
    assert sorted(x for v in p1.values() for x in v) == every
    # The first design's map: chunk c of tensor k at block sum_start[k] + c,
    # thread t its elements c·4096 + t + 256 i in i's order.
    for (blk, t), elems in p1.items():
        assert [e for _, e in elems] == sorted(e for _, e in elems)
        assert all(e % SUM_CHUNK % THREADS == t for _, e in elems)
    assert sorted(_pass2_elements(plan, numels)) == every


def test_table_matches_the_c_struct():
    """The ctypes table has csrc/adam.cu's AdamTable fields, in its order
    and at its layout (pointers, counts, two first-chunk tables of
    MAX_TENSORS + 1, the vec bytes, the tensor count)."""
    src = (ROOT / "rainbow_tpu_torch/kernels/csrc/adam.cu").read_text()
    body = re.search(r"struct AdamTable \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//.*", "", body)
    names = re.findall(r"(\w+)(?:\[[^\]]*\])?;", body)
    assert names == [f for f, _ in k9._Table._fields_]
    n = k9.MAX_TENSORS
    assert ctypes.sizeof(k9._Table) == 8 * (4 * n + n) + 4 * 2 * (n + 1) \
        + n + 4 + 4  # padded to 8
    assert f"#define MAX_TENSORS {n}" in src
    for bit, name in zip(VEC_BITS, ("P", "G", "MU", "NU")):
        assert f"#define VEC_{name} {bit}" in src


def test_adam_source_exports_what_the_wrapper_binds(monkeypatch):
    """csrc/adam.cu exports adam_clip_step with as many parameters as
    kernels/adam.py declares, and the sizes the wrapper checks."""
    src = (ROOT / "rainbow_tpu_torch/kernels/csrc/adam.cu").read_text()
    lib = types.SimpleNamespace(
        adam_clip_step=types.SimpleNamespace(),
        adam_max_tensors=lambda: k9.MAX_TENSORS,
        adam_chunk=lambda: SUM_CHUNK, adam_update_chunk=lambda: UPDATE_CHUNK,
        adam_threads=lambda: THREADS)
    monkeypatch.setattr(build, "load", lambda name: lib)
    fn = k9._lib.__wrapped__()
    sig = re.search(r'extern "C" int adam_clip_step\(([^)]*)\)', src)
    assert sig and fn is lib.adam_clip_step
    assert len(sig.group(1).split(",")) == len(fn.argtypes)
    assert fn.restype is not None
    for name in ("adam_max_tensors", "adam_chunk", "adam_update_chunk",
                 "adam_threads"):
        assert f'extern "C" int {name}()' in src


@pytest.mark.parametrize("numels, keep", [
    ([k9.KEEP_G_MAX], True), ([1, k9.KEEP_G_MAX - 1], True),
    ([k9.KEEP_G_MAX + 1], False), ([k9.KEEP_G_MAX, 1], False)])
def test_keep_g_where_it_fits_a_third_of_l2(numels, keep):
    """Pass 1 asks L2 to keep g's lines for pass 2 up to KEEP_G_MAX
    elements in all (16 MB of the H100's 50 MB)."""
    assert 4 * k9.KEEP_G_MAX * 3 <= 50 << 20
    plan = adam_plan(numels, [(0, 0, 0, 0)] * len(numels), 4)
    assert plan.keep_g == keep
