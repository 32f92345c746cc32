"""Correctness on the card: every kernel of the port, and every path that
runs them, against its plain PyTorch version. These need an NVIDIA GPU and
nvcc (every kernel is CUDA C++); without a card every test here skips. On
the card, from the repository root (--noconftest: tests/conftest.py sets up
JAX, which the port does not need):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

chip_smoke.py runs this module as its second phase. The main path's calls
are cases here, derived in tests/card_cases.py from the configurations
chip_smoke.py's Trainers run (the canonical preset at 1,024 envs and
PRESET_RUNS) and from each cell of BENCHMARK.json as cli.main builds it
(bench_cells): KA's forward and backward at every batch and noise mode
their nets call it with (noisy_layer_batches), K9 over each net, KB, the
C51 kernels and K2 at each configuration's batches and draws, one learner
update and one act of each; a new cell's shapes are cases without an edit.
Small, ragged and edge shapes sit beside them.

Tolerances: float32 sums in other orders agree to 1e-4; bf16 differs by a
few bf16 ulps of O(1) values (the plain versions round after every op, the
kernels once, and cuBLAS's bf16 products here sum in float32 and round
once); the noisy-linear kernels, which add their split partial sums in a
fixed order, give the same bits on a second launch, float32 and bf16
alike; a bf16 call launches only their tensor-core kernels (read from a
captured graph's kernel nodes); the float32 backward's large path is held
to the plain version in float64 at the cells' and presets' batches, ragged
and through unaligned views, and only its calls count as
noisy_linear_bwd_large launches; the head combines in the streams' dtype
on both sides, its float32 softmax's probabilities agree to 1e-6 and its
log-probabilities and q to 1e-5; integer work is bit-exact: the append +
frame-stack kernel (KC) at N = 1 to 1024, no, bucketed and dense reset
rows, H = 4 (vector path) and 3, in one launch an append. The noise kernel
(K2) computes Box-Muller in float32, its plain version in float64 with one
rounding: they agree to 1e-5 with the same signs, on the draws and on
chosen words, and a round's 71 M target draws have the noise's moments;
the delta kernel (K10) is bit-exact, on real pong deltas too, in one kernel
node. The replay's sampler (K5) is bit-exact, on ties and on trees of depth
0 to 22, in the launches its plan counts (at most two) and with no
allocation but its outputs; its gather (K6), one kernel node a call,
copies frames, actions and nonterminals exactly and its returns and IS
weights agree to 1e-6 relative, at windows of 7 and 24, on the canonical
7 GB ring too; its write-back (K7) writes the last of consecutive draws of
a leaf, exactly, at B = 1 to 8192, with runs across its blocks' edges, and
makes max_priority NaN on a NaN loss as torch.maximum does, in one kernel
node; a second launch of each gives the same bits. Adam's kernel does the
plain version's float32 ops in the same order except the global norm's
sum, so params agree to 1e-7 after three steps (3·lr·2^-7 with a bf16 mu,
where a rounding that falls the other way moves an update by 2^-7 of lr),
and two runs give the same bits, on small ragged tensors and on each net,
each tensor of its own or every kind as views of one flat buffer; it is
two kernel nodes, and its C entry refuses a plan that disagrees; on the
canonical net it gives the digests read before its table grew from 32
entries to 64. One learner update of each full-size configuration and of
each benchmark cell at its batch on the card against the plain path on the
CPU within PLAIN_TOL of its compute dtype, in the launches one update
needs, and a KA backward that drops input chunks fails that check; one
actor step of each on live pong states, in one launch of KA a layer and
one of KB and KC; a learner update of the IMPALA cell's net, like one of
the float32 Nature net, launches no NCHW <-> NHWC conversion and no NCHW
max pool. After a learner round, params agree to lr/100. The distributed
round at world size 1 over NCCL gives learner_round's bits, with cuDNN
held to its deterministic algorithms.
"""
import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

import card_cases
import rainbow_tpu_torch
from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.envs.fake import FakeAtariEnv
from rainbow_tpu_torch.kernels import LAUNCHES, launches, reset_launches
from rainbow_tpu_torch.kernels import c51 as k4
from rainbow_tpu_torch.kernels.adam import clip_adam
from rainbow_tpu_torch.kernels.append_framestack import append_framestack
from rainbow_tpu_torch.kernels.dueling_head import dueling_head_fwd
from rainbow_tpu_torch.kernels import replay as k_replay
from rainbow_tpu_torch.kernels.noisy_linear import (bwd_plan, fwd_plan,
                                                    noisy_linear_bwd,
                                                    noisy_linear_fwd)
from rainbow_tpu_torch.models import dqn
from rainbow_tpu_torch.models.dqn import draw_noise, init_dqn_params
from rainbow_tpu_torch.kernels.delta import apply_delta
from rainbow_tpu_torch.kernels.noise import box_muller, scaled_noise
from rainbow_tpu_torch.models.noisy import (NoiseStream, init_noisy_params,
                                            noisy_linear_bwd_plain,
                                            noisy_linear_plain,
                                            philox_noise_plain, scale_noise,
                                            scaled_box_muller_plain)
from rainbow_tpu_torch.ops import c51 as oc51
from rainbow_tpu_torch.ops import preprocess as pp
from rainbow_tpu_torch.ops.c51 import support_vector
from rainbow_tpu_torch.ops.head import dueling_head_plain
from rainbow_tpu_torch.parallel import learner as pl
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch import train as ttrain
from rainbow_tpu_torch.train import actor_step_packed, pack_resets, stage_step

pytestmark = pytest.mark.cuda

# The configurations whose calls the tests below take as cases
# (card_cases): the canonical preset at 1,024 envs and chip_smoke.py's
# PRESET_RUNS (each checked in float32 and bf16 where a test takes both),
# and BENCHMARK.json's cells as cli.main builds them (in their own dtype),
# with pong's 6 actions.
N_ACT = card_cases.PONG_ACTIONS
CONFIGS = card_cases.configs()
CELLS = card_cases.bench_cells()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The plain versions' bf16 products sum in float32 and round once, as
    # KA's do: cuBLAS's split-K otherwise rounds each partial sum to bf16,
    # which at 1,024 and 2,048 rows over fc_z_a's 306 x 512 took the plain
    # backward's dw_mu 0.82 from the float64 sum, where KA's is within 0.50.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


# (B, in, out): ragged against every tile edge (scalar loads); the learner's
# fc_h (small-batch path, split); one row; the edges of both splits with
# scalar loads; the actor's fc_h (large-batch path, split); the
# data-efficient net's fc_h (576 -> 256) at its learner's batch (small
# path, 18 input chunks), its actor's 16 envs and its round's 512 target
# rows (small path, three input chunks of at most 256, per-row noise in
# the "row" mode).
NOISY_SHAPES = [(37, 301, 70), (32, 3136, 512), (1, 512, 51),
                (33, 3137, 513), (1024, 3136, 512), (32, 576, 256),
                (16, 576, 256), (512, 576, 256)]


def _noisy_case(cuda, seed, shape, mode, dt):
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, n_in, n_out = shape
    prm = init_noisy_params(g, n_in, n_out, 0.5)
    x = (torch.rand((b, n_in), generator=g, device=cuda) * 2).to(dt)
    gy = torch.randn((b, n_out), generator=g, device=cuda).to(dt)
    lead = (b,) if mode == "row" else ()
    ns = NoiseStream(seed)
    eps = None if mode == "mu" else (scale_noise(ns, lead + (n_in,), cuda),
                                     scale_noise(ns, lead + (n_out,), cuda))
    return prm, x, gy, eps


MODES, DTYPES = ("mu", "shared", "row"), ("float32", "bfloat16")


def _ka_cases(fwd, edges):
    """KA's cases as (shape, mode, dtype), each once: NOISY_SHAPES in every
    mode and both dtypes; ``edges`` (shape, modes) in both dtypes; each
    configuration's layers at every batch and noise mode it calls KA with
    (card_cases.ka_calls: forward, the act over its envs, the evaluation's
    10 and 250 rows, the learner's batch and the round's target rows;
    backward, the learner's batch), in both dtypes for CONFIGS and in its
    own for each benchmark cell."""
    out = []
    for case in ([(s, m, d) for s in NOISY_SHAPES for m in MODES
                  for d in DTYPES]
                 + [(s, m, d) for s, modes in edges for m in modes
                    for d in DTYPES]
                 + card_cases.ka_calls(CONFIGS, CELLS, fwd)):
        if case not in out:
            out.append(case)
    return out


def _ka_ids(ka):
    return [f"{s}-{m}-{d}" for s, m, d in ka]


# Beyond the configurations' calls: one row and an actor's batch of per-row
# noise over a layer ragged against every tile edge (scalar loads).
KA_FWD_CASES = _ka_cases(True, [((1, 3136, 512), MODES),
                                ((1024, 3137, 513), ("row",))])
KA_BWD_CASES = _ka_cases(False, [((1, 3136, 512), MODES)])


@pytest.mark.parametrize("shape,mode,dtype", KA_FWD_CASES,
                         ids=_ka_ids(KA_FWD_CASES))
def test_noisy_linear_kernel_matches_plain(cuda, shape, mode, dtype):
    """KA's forward against noisy_linear_plain, with and without the ReLU;
    a second launch gives the same bits."""
    dt = getattr(torch, dtype)
    prm, x, _, eps = _noisy_case(cuda, 0, shape, mode, dt)
    tol = (1e-4, 1e-4) if dt == torch.float32 else (6e-2, 3e-2)
    for relu in (False, True):
        got = noisy_linear_fwd(prm, x, eps, relu)
        want = noisy_linear_plain(prm, x, eps, relu)
        assert got.dtype == dt and got.shape == (shape[0], shape[2])
        torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                                   rtol=tol[1])
        assert torch.equal(noisy_linear_fwd(prm, x, eps, relu), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(32, 3136, 512), (33, 3137, 513),
                                   (1024, 3136, 512), (512, 576, 256)],
                         ids=str)
def test_noisy_linear_kernels_give_the_same_bits_twice(cuda, shape, dtype):
    """The splits add their partial sums in a fixed order, without atomics:
    two launches of either kernel give equal bits, on the CUDA cores
    (float32) and on the tensor cores (bfloat16)."""
    for mode in ("shared", "row"):
        prm, x, gy, eps = _noisy_case(cuda, 5, shape, mode,
                                      getattr(torch, dtype))
        w = (prm["weight_mu"], prm["weight_sigma"])
        y = noisy_linear_fwd(prm, x, eps, True)
        assert torch.equal(noisy_linear_fwd(prm, x, eps, True), y)
        first = noisy_linear_bwd(*w, x, gy, eps, y)
        for a, c in zip(noisy_linear_bwd(*w, x, gy, eps, y), first):
            assert torch.equal(a, c)


# (B, A, atoms) of the head kernels (csrc/head.cu): one row, a ragged block,
# a full learner batch and one row past it, the actor's batch; A from
# Atari's smallest set to its full one; the canonical 51 atoms, a single
# lane column (21) and the most a lane holds (MAX_ATOMS = 128).
HEAD_SHAPES = [(b, n_act, atoms) for b in (1, 29, 31, 32, 33, 1024)
               for n_act in (3, 6, 18) for atoms in (51, 21, 128)]


def _head_streams(g, b, n_act, atoms, dt):
    v = (torch.randn((b, atoms), generator=g, device=g.device) * 2).to(dt)
    a = (torch.randn((b, n_act * atoms), generator=g, device=g.device)
         * 2).to(dt)
    return v, a


def _head_batches():
    """KB's batches in each configuration and cell, {B: its modes}: the act
    over its envs and the evaluation's 10 and 250 rows in every mode, the
    learner's double-Q selection without a distribution, the round's
    target rows with probabilities."""
    out = {}
    for _, c in CONFIGS + CELLS:
        rows = c.num_envs // c.replay_frequency * c.batch_size
        every = (None, "probs", "log")
        for b, dists in ((c.num_envs, every), (10, every), (250, every),
                         (c.batch_size, (None,)), (rows, ("probs",))):
            have = out.get(b, ())
            out[b] = have + tuple(d for d in dists if d not in have)
    return out


HEAD_BATCHES = _head_batches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dist", [None, "probs", "log"])
def test_dueling_head_kernel_matches_plain(cuda, dist, dtype):
    """KB against its plain version at HEAD_SHAPES, at the round's 8192-row
    target with probabilities and at each of HEAD_BATCHES in its modes with
    pong's and the full action set, 51 atoms; a second launch gives the
    same bits, and in a row whose best q is tied the first of the tied
    actions wins. Probabilities below 1 agree to 1e-6, log-probabilities
    and q of order 10 to 1e-5."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    shapes = HEAD_SHAPES + ([(8192, 6, 51)] if dist == "probs" else [])
    shapes += [(b, n_act, 51) for b, dists in HEAD_BATCHES.items()
               if dist in dists for n_act in (N_ACT, 18)]
    for b, n_act, atoms in dict.fromkeys(shapes):
        z = support_vector(-10.0, 10.0, atoms, cuda)
        v, a = _head_streams(g, b, n_act, atoms, dt)
        # Row 0: actions 1 and 2 lean to the high atoms alike, the others
        # to the low ones, so q ties at its top between 1 and 2.
        j = torch.arange(atoms, device=cuda, dtype=torch.float32) / atoms
        lean = torch.stack([j if k in (1, 2) else -j for k in range(n_act)])
        a[0] = (lean * 4).reshape(-1).to(dt)
        got = dueling_head_fwd(v, a, z, n_act, dist)
        want = dueling_head_plain(v, a, z, n_act, dist)
        tag = f"B={b} A={n_act} atoms={atoms}"
        torch.testing.assert_close(got[1], want.q, atol=1e-5, rtol=0,
                                   msg=tag)
        torch.testing.assert_close(got[3], want.max_q, atol=1e-5, rtol=0,
                                   msg=tag)
        if dist:
            torch.testing.assert_close(got[0], want.dist, rtol=0, msg=tag,
                                       atol=1e-6 if dist == "probs" else 1e-5)
        else:
            assert got[0] is None
        top2 = want.q.topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > 1e-5
        assert torch.equal(got[2][clear], want.action[clear]), tag
        assert got[1][0, 1] == got[1][0, 2] and int(got[2][0]) == 1, tag
        again = dueling_head_fwd(v, a, z, n_act, dist)
        for x, y in zip(again, got):
            assert (x is None and y is None) or torch.equal(x, y), tag


def _same(a, b):
    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


def _kc_step(rng, n, k_mode):
    """One step's kinds and reset rows: none (K = 0), packed by pack_resets
    into a padded bucket, or dense (K = N, arange(N), as actor_step)."""
    kinds = rng.integers(0, 3, n).astype(np.uint8)
    if k_mode == "none":
        kinds[:] = 0
    resets = rng.integers(0, 256, (n, 84, 84), np.uint8)
    if k_mode == "dense":
        return kinds, resets, np.arange(n, dtype=np.int32)
    return (kinds, *pack_resets(resets, kinds))


@pytest.mark.parametrize("with_rep", [True, False], ids=["replay", "stack"])
@pytest.mark.parametrize("k_mode", ["none", "bucket", "dense"])
@pytest.mark.parametrize("n", [1, 10, 16, 40, 1024])
@pytest.mark.parametrize("history", [4, 3])
def test_append_framestack_kernel_matches_plain(cuda, history, n, k_mode,
                                                with_rep):
    """KC against its plain version, bit for bit, over four appends in a
    row that wrap a three-column ring: the stack, the ring and its write
    head after each."""
    rng = np.random.default_rng(2)
    c = 3
    u8 = lambda *s: torch.from_numpy(rng.integers(0, 256, s, np.uint8))
    stack0 = u8(n, 84, 84, history)
    states = {dev: (stack0.to(dev, copy=True), rp.init_replay(n, c, 84, dev))
              for dev in ("cuda", "cpu")}
    for step in range(4):
        kinds, packed, ridx = _kc_step(rng, n, k_mode)
        inputs = [u8(n, 84, 84), torch.from_numpy(packed),
                  torch.from_numpy(ridx), torch.from_numpy(kinds)]
        extra = [torch.from_numpy(rng.integers(0, 6, n)),
                 torch.from_numpy(rng.normal(size=n).astype(np.float32) * 3),
                 torch.from_numpy(kinds > 0)]
        for dev, fn in (("cuda", append_framestack),
                        ("cpu", pp.append_framestack_plain)):
            stack, rep = states[dev]
            fn(stack, *(t.to(dev) for t in inputs),
               *((rep, *(t.to(dev) for t in extra), 1.0) if with_rep
                 else ()))
        assert torch.equal(states["cuda"][0].cpu(), states["cpu"][0])
        assert _same(states["cuda"][1], states["cpu"][1])
        if with_rep:
            assert int(states["cuda"][1].index) == (step + 1) % c
            assert bool(states["cuda"][1].full) == (step + 1 >= c)


class _KernelNodeParams(ctypes.Structure):
    """libcuda's CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p)]
    _fields_ += [(f, ctypes.c_uint) for f in (
        "gridDimX", "gridDimY", "gridDimZ", "blockDimX", "blockDimY",
        "blockDimZ", "sharedMemBytes")]
    _fields_ += [(f, ctypes.c_void_p) for f in (
        "kernelParams", "extra", "kern", "ctx")]


def _kernel_name(drv, node):
    """The (mangled) name of a graph kernel node's function."""
    prm = _KernelNodeParams()
    assert drv.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                             ctypes.byref(prm)) == 0
    name = ctypes.c_char_p()
    if prm.func:
        assert drv.cuFuncGetName(ctypes.byref(name),
                                 ctypes.c_void_p(prm.func)) == 0
    else:
        assert drv.cuKernelGetName(ctypes.byref(name),
                                   ctypes.c_void_p(prm.kern)) == 0
    return name.value.decode()


def _graph_kernels(fn, names=None):
    """(kernel nodes, all nodes) of a CUDA graph that captures one call of
    ``fn``, after one call outside the capture on the capturing stream
    (which allocates that stream's kept buffers), counted with libcuda's
    graph calls (the profiler can miss a short window's first kernel).
    With a list ``names``, the kernel nodes' function names are appended
    to it in the graph's node order."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert drv.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0
        kinds.append(kind.value)
        if names is not None and kind.value == 0:
            names.append(_kernel_name(drv, node))
    del graph
    return kinds.count(0), len(kinds)  # CU_GRAPH_NODE_TYPE_KERNEL is 0


@pytest.mark.parametrize("with_rep", [True, False], ids=["replay", "stack"])
def test_append_framestack_launches_once_per_append(cuda, with_rep):
    """One kernel per append, with a replay too (its last block advances the
    write head): seven appends in a row into a three-column ring leave
    index and full as the plain version does after each."""
    rng = np.random.default_rng(4)
    n, c = 1024, 3
    stack = torch.from_numpy(rng.integers(0, 256, (n, 84, 84, 4),
                                          np.uint8)).to(cuda)
    rep = rp.init_replay(n, c, 84, cuda)
    for step in range(7):
        kinds, packed, ridx = _kc_step(rng, n, "bucket")
        args = [torch.from_numpy(a).to(cuda) for a in (
            rng.integers(0, 256, (n, 84, 84), np.uint8), packed, ridx,
            kinds)]
        extra = ((rep, torch.zeros(n, dtype=torch.int64, device=cuda),
                  torch.zeros(n, device=cuda),
                  torch.from_numpy(kinds > 0).to(cuda), 1.0)
                 if with_rep else ())
        # Runs the append once, and captures it once more without running.
        assert _graph_kernels(lambda: append_framestack(stack, *args,
                                                        *extra)) == (1, 1)
        assert int(rep.index) == ((step + 1) % c if with_rep else 0)
        assert bool(rep.full) == (with_rep and step + 1 >= c)


@pytest.mark.parametrize("arg,offset,align", [("stack", 4, 16),
                                              ("obs", 2, 4)])
def test_append_framestack_refuses_misaligned_vector_inputs(cuda, arg,
                                                            offset, align):
    """The vector path (H = 4, 84·84 % 4 == 0) moves the stack 16 bytes and
    obs, reset rows and frames 4 bytes at a time: the wrapper raises on a
    tensor that is not so aligned, before any launch."""
    n = 2
    shapes = {"stack": (n, 84, 84, 4), "obs": (n, 84, 84)}
    t = {}
    for name, shape in shapes.items():
        off = offset if name == arg else 0
        raw = torch.zeros(int(np.prod(shape)) + off, dtype=torch.uint8,
                          device=cuda)
        t[name] = raw[off:].view(shape)
    reset_launches()
    with pytest.raises(ValueError, match=f"{arg} must be {align}-byte"):
        append_framestack(t["stack"], t["obs"],
                          torch.zeros(0, 84, 84, dtype=torch.uint8,
                                      device=cuda),
                          torch.zeros(0, dtype=torch.int32, device=cuda),
                          torch.zeros(n, dtype=torch.uint8, device=cuda))
    assert launches()["append_framestack"] == 0


def _live_pong_state(cfg, params, envs, iters=6):
    """A live acting state of ``cfg``'s net on the card: ``envs`` pong envs
    of the native engine stepped ``iters`` times by actor_step_packed with
    a 16-column ring (resets come from the first step: the engine's no-op
    starts). Returns (stack, the last step's staged inputs, the actions
    after it)."""
    env = ttrain.make_env_factory(cfg)(num_envs=envs, training=True)
    try:
        assert env.action_space == N_ACT
        stack = pp.init_framestack(envs, cfg.history_length, env.reset_all(),
                                   "cuda")
        rep = rp.init_replay(envs, 16, cfg.frame_size, "cuda")
        noise = NoiseStream(11)
        actions = ag.act(params, cfg, N_ACT, pp.to_network_input(stack),
                         noise)
        for _ in range(iters):
            staged = stage_step(env.step(actions.cpu().numpy()), "cuda")
            actions = actor_step_packed(params, noise, cfg, N_ACT, stack, rep,
                                        actions, *staged)
    finally:
        env.close()
    return stack, staged, actions


def _check_pong_actor_step(cfg):
    """One actor iteration of ``cfg``'s net on a live pong state of
    min(32, envs) envs, through the kernels on the card and through the
    plain versions on the CPU, with the same injected per-env noise: stack
    and replay bit-exact, q within PLAIN_TOL of the compute dtype, actions
    equal wherever the top-2 gap of q is clear of that tolerance; the
    card's iteration launches KA once a layer, KB and KC once, the CPU's
    nothing."""
    from rainbow_tpu_torch.models.dqn import forward_head

    n = min(32, cfg.num_envs)
    params = init_dqn_params(cfg, N_ACT, 12, "cuda")
    stack, staged, actions = _live_pong_state(cfg, params, n)
    noise = draw_noise(cfg, N_ACT, NoiseStream(5), (n,), "cpu")
    out, counts = {}, {}
    for dev in ("cuda", "cpu"):
        st = stack.to(dev, copy=True)
        rep = rp.init_replay(n, 4, 84, dev)
        p = {k: v.to(dev) for k, v in params.items()}
        ne = {k: (a.to(dev), b.to(dev)) for k, (a, b) in noise.items()}
        reset_launches()
        act = actor_step_packed(p, None, cfg, N_ACT, st, rep, actions.to(dev),
                                *(t.to(dev) for t in staged), noise_eps=ne)
        counts[dev] = launches()
        q = forward_head(p, cfg, N_ACT, pp.to_network_input(st),
                         noise_eps=ne).q
        out[dev] = (act.cpu(), st.cpu(), rep, q.cpu().float())
    assert counts["cuda"] == dict(dict.fromkeys(LAUNCHES, 0),
                                  noisy_linear_fwd=4, dueling_head=1,
                                  append_framestack=1)
    assert counts["cpu"] == dict.fromkeys(LAUNCHES, 0)
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert _same(out["cuda"][2], out["cpu"][2])
    tol = PLAIN_TOL[cfg.compute_dtype]
    q = out["cpu"][3]
    torch.testing.assert_close(out["cuda"][3], q, atol=tol["q"][0],
                               rtol=tol["q"][1])
    top2 = q.topk(2, dim=1).values
    atol, rtol = tol["gap"]
    clear = top2[:, 0] - top2[:, 1] > atol + rtol * top2[:, 0].abs()
    assert torch.equal(out["cuda"][0][clear], out["cpu"][0][clear])


@pytest.mark.parametrize("case", ["fake"] + [f"pong-{label}"
                                            for label, _ in CONFIGS + CELLS])
def test_actor_steps_on_card_match_cpu(cuda, case):
    """Five actor iterations on the fake env through the kernels and through
    the plain versions, with the same injected noise; and (pong-*) one
    actor step of each full-size configuration and each benchmark cell on
    live pong states (_check_pong_actor_step)."""
    if case != "fake":
        _check_pong_actor_step(dict(CONFIGS + CELLS)[case[len("pong-"):]])
        return
    cfg = rainbow_tpu_torch.data_efficient(hidden_size=32)
    n, a_space = 8, 4
    params = init_dqn_params(cfg, a_space, 0, "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        env = FakeAtariEnv(n, episode_len=6, life_every=4)
        stack = pp.init_framestack(n, 4, env.reset_all(), dev)
        rep = rp.init_replay(n, 4, 84, dev)
        p = {k: v.to(dev) for k, v in params.items()}
        acts = torch.zeros(n, dtype=torch.int64, device=dev)
        reset_launches()
        history = []
        for i in range(5):
            noise = draw_noise(cfg, a_space, NoiseStream(i), (n,), "cpu")
            noise = {k: (x.to(dev), y.to(dev)) for k, (x, y) in noise.items()}
            out = env.step(np.zeros(n, np.int64) + i % a_space)
            acts = actor_step_packed(p, None, cfg, a_space, stack, rep, acts,
                                     *stage_step(out, dev), noise_eps=noise)
            history.append(acts.cpu())
        runs[dev] = (stack.cpu(), rep, history, launches())
    assert torch.equal(runs["cuda"][0], runs["cpu"][0])
    assert _same(runs["cuda"][1], runs["cpu"][1])
    assert runs["cuda"][3] == dict(dict.fromkeys(LAUNCHES, 0),
                                   noisy_linear_fwd=20, dueling_head=5,
                                   append_framestack=5)
    assert runs["cpu"][3] == dict.fromkeys(LAUNCHES, 0)
    agree = sum(torch.equal(x, y) for x, y in zip(runs["cuda"][2],
                                                   runs["cpu"][2]))
    assert agree >= 4  # a near-tie may flip one step's argmax


@pytest.mark.parametrize("shape,mode,dtype", KA_BWD_CASES,
                         ids=_ka_ids(KA_BWD_CASES))
def test_noisy_linear_bwd_kernel_matches_plain(cuda, shape, mode, dtype):
    """KA's backward against noisy_linear_bwd_plain (dx and the four
    param gradients), with and without the ReLU's mask; a second launch
    gives the same bits."""
    dt = getattr(torch, dtype)
    prm, x, gy, eps = _noisy_case(cuda, 3, shape, mode, dt)
    tol = (1e-4, 1e-4) if dt == torch.float32 else (6e-2, 3e-2)
    w = (prm["weight_mu"], prm["weight_sigma"])
    for relu in (False, True):
        y = noisy_linear_fwd(prm, x, eps, relu) if relu else None
        got = noisy_linear_bwd(*w, x, gy, eps, y)
        want = noisy_linear_bwd_plain(*w, x, gy, eps, y)
        assert got[0].dtype == dt
        for a, c in zip(got, want):
            torch.testing.assert_close(a.float(), c.float(), atol=tol[0],
                                       rtol=tol[1])
        again = noisy_linear_bwd(*w, x, gy, eps, y)
        assert all(torch.equal(a, c) for a, c in zip(again, got))


@pytest.mark.parametrize("shape", [(10, 3136, 512), (32, 3136, 512),
                                   (250, 3136, 512), (1024, 3136, 512),
                                   (8192, 3136, 512), (33, 3137, 513)],
                         ids=str)
def test_bf16_noisy_linear_launches_only_tensor_core_kernels(cuda, shape):
    """A bf16 forward and backward, captured in a CUDA graph, hold only the
    tensor-core kernels (mma.sync, noisy_linear_fwd_mma and
    noisy_linear_bwd_mma) and, where the plan splits, their ordered bf16
    reduces: no CUDA-core bf16 kernel is left, at the evaluation's,
    learner's, validation's, actor's and round's batches and at a ragged
    shape, in each noise mode."""
    b, n_in, n_out = shape
    modes = ("mu", "shared", "row")
    for mode in modes:
        prm, x, gy, eps = _noisy_case(cuda, 7, shape, mode, torch.bfloat16)
        w = (prm["weight_mu"], prm["weight_sigma"])
        y = noisy_linear_fwd(prm, x, eps, True)
        for call, plan, main, reduce in (
                (lambda: noisy_linear_fwd(prm, x, eps, True),
                 fwd_plan(b, n_in, n_out, modes.index(mode), torch.bfloat16),
                 "noisy_linear_fwd_mma", "noisy_linear_fwd_reduce"),
                (lambda: noisy_linear_bwd(*w, x, gy, eps, y),
                 bwd_plan(b, n_in, n_out, modes.index(mode), torch.bfloat16),
                 "noisy_linear_bwd_mma", "noisy_linear_dx_reduce")):
            names = []
            _graph_kernels(call, names)
            # Without noise the backward also zero-fills the σ grads.
            ka = [n for n in names if "noisy_linear" in n]
            want = [main] + ([reduce] if plan.splits > 1 else [])
            assert len(ka) == len(want), (mode, names)
            for name, stem in zip(ka, want):
                assert stem in name, (mode, name)
            if plan.splits > 1:
                assert "__nv_bfloat16" in ka[1], (mode, ka[1])


# The float32 backward's large path (noisy_linear_bwd_large, from
# BWD_LARGE_ROWS rows with no or shared noise): fc_h at the batches of the
# cells and presets that reach it and twice the canonical cell's, pong's
# fc_z layers at the canonical cell's batch (their batch split into
# chunks), and a shape ragged against every tile edge (split dx and
# weights).
LARGE_BWD_SHAPES = [(128, 3136, 512), (256, 3136, 512), (1024, 3136, 512),
                    (2048, 3136, 512), (1024, 512, 51), (1024, 512, 306),
                    (200, 301, 70)]


def _offset_view(t, offset):
    """t's values in a contiguous view that starts ``offset`` floats into a
    larger buffer: an offset of 1 makes it unaligned for 16-byte loads."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("mode", ["mu", "shared"])
@pytest.mark.parametrize("shape", LARGE_BWD_SHAPES, ids=str)
def test_large_noisy_linear_bwd_matches_plain(cuda, shape, mode, offset):
    """The large path against noisy_linear_bwd_plain in float64, with and
    without the ReLU's mask; with offset 1 every input is a view one float
    into its buffer, so each copy and store takes the 4-byte path.
    Tolerance: float32 sums of up to 2,048 O(1) products, each a chain of
    fmaf in another order than the reference's; their rounding is a few
    ulps of the sums' scale, K·2^-24 ≈ 1.2e-4 of it at K = 2,048, so 1e-5
    of the largest |reference| (at least 1) plus 1e-4 relative."""
    b, n_in, n_out = shape
    plan = bwd_plan(b, n_in, n_out, 1 if mode == "shared" else 0)
    assert plan.path == "large"
    prm, x, gy, eps = _noisy_case(cuda, 13, shape, mode, torch.float32)
    w = tuple(_offset_view(prm[k], offset)
              for k in ("weight_mu", "weight_sigma"))
    x, gy = _offset_view(x, offset), _offset_view(gy, offset)
    if eps is not None:
        eps = tuple(_offset_view(e, offset) for e in eps)
    d = lambda t: None if t is None else t.double()
    for relu in (False, True):
        y = (_offset_view(noisy_linear_fwd(prm, x, eps, True), offset)
             if relu else None)
        got = noisy_linear_bwd(*w, x, gy, eps, y)
        want = noisy_linear_bwd_plain(
            *map(d, w), d(x), d(gy),
            None if eps is None else tuple(map(d, eps)), d(y))
        for a, c in zip(got, want):
            assert a.dtype == torch.float32
            scale = max(1.0, float(c.abs().max()))
            torch.testing.assert_close(a.double(), c.double(),
                                       atol=1e-5 * scale, rtol=1e-4)


@pytest.mark.parametrize("shape", [(1024, 3136, 512), (1024, 512, 306),
                                   (200, 301, 70)], ids=str)
def test_large_noisy_linear_bwd_gives_the_same_bits_twice(cuda, shape):
    """No float atomics: the split shapes' partials are added in chunk
    order, so two launches of the large path give equal bits."""
    b, n_in, n_out = shape
    for mode in ("mu", "shared"):
        prm, x, gy, eps = _noisy_case(cuda, 17, shape, mode, torch.float32)
        w = (prm["weight_mu"], prm["weight_sigma"])
        y = noisy_linear_fwd(prm, x, eps, True)
        first = noisy_linear_bwd(*w, x, gy, eps, y)
        for a, c in zip(noisy_linear_bwd(*w, x, gy, eps, y), first):
            assert torch.equal(a, c)


@pytest.mark.parametrize("shape", [(32, 3136, 512), (1024, 3136, 512),
                                   (1024, 512, 51)], ids=str)
def test_noisy_linear_bwd_paths_kernels_and_launch_counts(cuda, shape):
    """Every call counts one noisy_linear_bwd launch; the calls that take
    the large path also count one noisy_linear_bwd_large and hold only its
    kernel (and, split, its ordered reduce); the others (B = 32, per-row
    noise, bf16) count none and launch none of it, so B = 32 runs the small
    path's kernels."""
    b, n_in, n_out = shape
    for mode, dt in (("shared", torch.float32), ("mu", torch.float32),
                     ("row", torch.float32), ("shared", torch.bfloat16)):
        prm, x, gy, eps = _noisy_case(cuda, 19, shape, mode, dt)
        w = (prm["weight_mu"], prm["weight_sigma"])
        y = noisy_linear_fwd(prm, x, eps, True)
        plan = bwd_plan(b, n_in, n_out, ("mu", "shared", "row").index(mode),
                        dt)
        large = plan.path == "large"
        assert large == (b >= 1024 and mode != "row"
                         and dt == torch.float32), (mode, dt)
        reset_launches()
        noisy_linear_bwd(*w, x, gy, eps, y)
        assert launches() == dict(dict.fromkeys(LAUNCHES, 0),
                                  noisy_linear_bwd=1,
                                  noisy_linear_bwd_large=int(large))
        names = []
        _graph_kernels(lambda: noisy_linear_bwd(*w, x, gy, eps, y), names)
        ka = [n for n in names if "noisy_linear" in n]
        if large:
            want = ["noisy_linear_bwd_large"] + (
                ["noisy_linear_bwd_large_reduce"]
                if max(plan.splits, plan.w_splits) > 1 else [])
        else:
            want = [("noisy_linear_bwd_kernel" if dt == torch.float32
                     else "noisy_linear_bwd_mma")] + (
                ["noisy_linear_dx_reduce"] if plan.splits > 1 else [])
        assert len(ka) == len(want), (mode, dt, names)
        for name, stem in zip(ka, want):
            assert stem in name and (large or "large" not in name), (
                mode, dt, name)


def _c51_learners():
    """The C51 kernels' learner shapes, {id: (B, γⁿ)}: a ragged batch, then
    each configuration's and cell's batch with its discount over n steps."""
    out = {"b37-n3": (37, 0.99 ** 3)}
    for _, c in CONFIGS + CELLS:
        key = (c.batch_size, c.discount ** c.multi_step)
        if key not in out.values():
            out[f"b{c.batch_size}-n{c.multi_step}"] = key
    return out


C51_LEARNERS = _c51_learners()


@pytest.mark.parametrize("learner", list(C51_LEARNERS))
def test_c51_target_kernel_matches_plain(cuda, learner):
    """The projection at each of C51_LEARNERS with pong's 6 actions: within
    1e-5 of the plain version, rows summing to 1, a second launch (int32
    a*) with the same bits, and terminal rows whose return sits exactly on
    an atom putting their whole mass there."""
    g = torch.Generator(device=cuda).manual_seed(4)
    (b, gamma_n), n_act = C51_LEARNERS[learner], 6
    z = support_vector(-10.0, 10.0, 51, cuda)
    pns = torch.softmax(torch.randn((b, n_act, 51), generator=g,
                                    device=cuda) * 2, dim=2)
    a_star = torch.randint(0, n_act, (b,), generator=g, device=cuda)
    ret = torch.rand((b,), generator=g, device=cuda) * 24 - 12
    nt = (torch.rand((b,), generator=g, device=cuda) > 0.3).float()
    # Integer b: terminal rows whose return sits exactly on an atom.
    ret[:3] = torch.tensor([-10.0, 0.0, 10.0], device=cuda)
    nt[:3] = 0.0
    got = k4.c51_target(pns, a_star, ret, nt, gamma_n, z, -10.0, 10.0)
    want = oc51.c51_target_plain(pns, a_star, ret, nt, gamma_n, z, -10.0,
                                 10.0)
    # b reaches 50, where a float32 ulp is 3.8e-6, and the kernel divides
    # by Δz where PyTorch multiplies by its reciprocal.
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.sum(1), torch.ones(b, device=cuda),
                               atol=1e-5, rtol=0)
    # Each row sums its source atoms in order: a second launch, with an
    # int32 a*, gives the same bits.
    again = k4.c51_target(pns, a_star.int(), ret, nt, gamma_n, z, -10.0,
                          10.0)
    assert torch.equal(again, got)
    # Integer b: the whole mass (Σp = 1 to float32 rounding) on one atom.
    for m in (got, want):
        for row, atom in ((0, 0), (1, 25), (2, 50)):
            rest = torch.cat((m[row, :atom], m[row, atom + 1:]))
            assert abs(float(m[row, atom]) - 1.0) < 1e-5, (row, atom)
            assert not bool(rest.any()), (row, atom)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c51_loss_kernel_matches_plain(cuda, dtype):
    """The loss kernel against its plain version: B = 37, A = 6, 51 atoms
    (two passes of the block's 32 warps), then HEAD_SHAPES with random
    target distributions, then each of C51_LEARNERS with pong's 6 actions
    on the plain projection of a target; a second launch gives the same
    bits. Losses of order 4 agree to 1e-5 and gradients of order w/B to
    1e-6. With bf16 streams, at HEAD_SHAPES' million-odd gradient values a
    rounding to bf16 can fall the other way where the float32 g differs in
    its last bit (Σm is summed in another order), so there dv and da may
    also differ by one bf16 ulp (2^-7 relative)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    cases = [(37, 6, 51, None)] + [(*s, None) for s in HEAD_SHAPES] + [
        (b, 6, 51, gamma_n) for b, gamma_n in C51_LEARNERS.values()]
    for i, (b, n_act, atoms, gamma_n) in enumerate(cases):
        v, a = _head_streams(g, b, n_act, atoms, dt)
        actions = torch.randint(0, n_act, (b,), generator=g, device=cuda)
        if i % 2:
            actions = actions.int()
        if gamma_n is None:
            m = torch.softmax(torch.randn((b, atoms), generator=g,
                                          device=cuda), dim=1)
        else:
            pns = torch.softmax(torch.randn((b, n_act, atoms), generator=g,
                                            device=cuda) * 2, dim=2)
            ret = torch.rand((b,), generator=g, device=cuda) * 24 - 12
            nt = (torch.rand((b,), generator=g, device=cuda) > 0.3).float()
            m = oc51.c51_target_plain(
                pns, actions, ret, nt, gamma_n,
                support_vector(-10.0, 10.0, atoms, cuda), -10.0, 10.0)
        w = torch.rand((b,), generator=g, device=cuda)
        got = k4.head_loss(v, a, actions, m, w)
        want = oc51.head_loss_plain(v, a, actions, m, w)
        rtol = 2 ** -7 if dt == torch.bfloat16 and i else 0.0
        tag = f"B={b} A={n_act} atoms={atoms} gamma^n={gamma_n}"
        assert got[2].dtype == got[3].dtype == dt, tag
        for x, y, atol, r in zip(got, want, (1e-5, 1e-5, 1e-6, 1e-6),
                                 (0, 0, rtol, rtol)):
            assert x.dtype == y.dtype and x.shape == y.shape, tag
            torch.testing.assert_close(x.float(), y.float(), atol=atol,
                                       rtol=r, msg=tag)
        for x, y in zip(k4.head_loss(v, a, actions, m, w), got):
            assert torch.equal(x, y), tag


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c51_kernels_at_the_throughput_batch(cuda, dtype):
    """The throughput preset's learner batch, B = 256 with A = 6 and 51
    atoms: the loss's cluster of 8 blocks loops over 8 passes of 32 rows
    with a cluster barrier between them, and the target runs 256 warps.
    Against the plain versions with the tolerances above (the target in
    float32, as the learner calls it; the loss with fp32 and bf16 streams),
    and a second launch of either gives the same bits."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(8)
    b, n_act = 256, 6
    z = support_vector(-10.0, 10.0, 51, cuda)
    pns = torch.softmax(torch.randn((b, n_act, 51), generator=g,
                                    device=cuda) * 2, dim=2)
    a_star = torch.randint(0, n_act, (b,), generator=g, device=cuda)
    ret = torch.rand((b,), generator=g, device=cuda) * 24 - 12
    nt = (torch.rand((b,), generator=g, device=cuda) > 0.3).float()
    m = k4.c51_target(pns, a_star, ret, nt, 0.99 ** 3, z, -10.0, 10.0)
    torch.testing.assert_close(m, oc51.c51_target_plain(
        pns, a_star, ret, nt, 0.99 ** 3, z, -10.0, 10.0), atol=1e-5, rtol=0)
    assert torch.equal(k4.c51_target(pns, a_star, ret, nt, 0.99 ** 3, z,
                                     -10.0, 10.0), m)
    v, a = _head_streams(g, b, n_act, 51, dt)
    actions = torch.randint(0, n_act, (b,), generator=g, device=cuda)
    w = torch.rand((b,), generator=g, device=cuda)
    got = k4.head_loss(v, a, actions, m, w)
    want = oc51.head_loss_plain(v, a, actions, m, w)
    rtol = 2 ** -7 if dt == torch.bfloat16 else 0.0
    for x, y, atol, r in zip(got, want, (1e-5, 1e-5, 1e-6, 1e-6),
                             (0, 0, rtol, rtol)):
        assert x.dtype == y.dtype and x.shape == y.shape
        torch.testing.assert_close(x.float(), y.float(), atol=atol, rtol=r)
    for x, y in zip(k4.head_loss(v, a, actions, m, w), got):
        assert torch.equal(x, y)


# K9's tensor lists: ragged small shapes, then each configuration's and
# cell's net (card_cases.adam_nets).
ADAM_SHAPES = card_cases.adam_nets(CONFIGS, CELLS)


def _adam_tensors(shapes, layout, dtype, dev, fill=None):
    """One tensor a shape, or views of one flat buffer at the running
    offsets (the data-parallel round's gradients; the small and canonical
    lists put later views at offsets that are not multiples of four)."""
    if layout == "separate":
        ts = [torch.zeros(s, dtype=dtype, device=dev) for s in shapes]
    else:
        numels = [math.prod(s) for s in shapes]
        flat = torch.zeros(sum(numels), dtype=dtype, device=dev)
        ts, at = [], 0
        for s, n in zip(shapes, numels):
            ts.append(flat[at:at + n].view(s))
            at += n
    if fill is not None:
        for i, t in enumerate(ts):
            t.copy_(fill(i, t.shape))
    return ts


@pytest.mark.parametrize("layout", ["separate", "flat_views"])
@pytest.mark.parametrize("shapes", list(ADAM_SHAPES))
@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["below", "above"])
def test_clip_adam_kernel_matches_plain(cuda, clip, mu_dtype, shapes,
                                        layout):
    # The nets' params at their scale: a rounding of the update that the
    # norm's sum order flips moves a param by one ulp, below 1e-7 there.
    p_scale = 1.0 if shapes == "small" else 0.05
    shapes = ADAM_SHAPES[shapes]
    g = torch.Generator(device=cuda).manual_seed(6)
    scale = 1e-3 if clip == "below" else 1.0
    mdt = getattr(torch, mu_dtype)
    states = {}
    for run in ("kernel", "plain", "again"):
        p = _adam_tensors(shapes, layout, torch.float32, cuda, lambda i, s:
                          torch.randn(s, generator=torch.Generator(
                              device=cuda).manual_seed(i), device=cuda)
                          * p_scale)
        states[run] = (p, _adam_tensors(shapes, layout, mdt, cuda),
                       _adam_tensors(shapes, layout, torch.float32, cuda),
                       torch.zeros((), dtype=torch.int32, device=cuda))
    if layout == "flat_views" and len(shapes) > 6:
        assert any(t.data_ptr() % 16 for t in states["kernel"][0])
    for _ in range(3):
        grads = _adam_tensors(shapes, layout, torch.float32, cuda,
                              lambda i, s: torch.randn(
                                  s, generator=g, device=cuda) * scale)
        norm = float(torch.sqrt(sum((x * x).sum() for x in grads)))
        assert (norm < 10) == (clip == "below")
        for run, fn in (("kernel", clip_adam), ("plain", ag.apply_grads_plain),
                        ("again", clip_adam)):
            p, mu, nu, count = states[run]
            fn(p, grads, mu, nu, count, 6.25e-5, 0.9, 0.999, 1.5e-4, 10.0)
    kp, kmu, knu, kc = states["kernel"]
    pp_, pmu, pnu, pc = states["plain"]
    assert int(kc) == int(pc) == 3
    p_tol = 1e-7 if mdt == torch.float32 else 3 * 6.25e-5 * 2 ** -7
    for x, y in zip(kp, pp_):
        torch.testing.assert_close(x, y, atol=p_tol, rtol=0)
    for x, y in zip(knu, pnu):
        torch.testing.assert_close(x, y, atol=0, rtol=1e-5)
    for x, y in zip(kmu, pmu):
        assert x.dtype == mdt
        torch.testing.assert_close(
            x.float(), y.float(), rtol=0,
            atol=float(y.float().abs().max()) * (1e-6 if mdt == torch.float32
                                                 else 2 ** -8))
    # Deterministic: a second run gives the same bits.
    for a, b in zip(states["kernel"][:3], states["again"][:3]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# SHA-256 of what K9 leaves (params, mu, nu, count) after chip_smoke.py's
# adam_digests: three steps at the canonical net's 22 tensors, gradients
# from a seed below, above and below the clip. Read on an H100 with the
# table of 32 entries that K9 had before it took 64 (the IMPALA net's 46
# tensors): a 22-tensor call keeps its bits.
K9_CANONICAL_DIGESTS = {
    "float32": {
        "params": "0bb7c08757420367c42e204438dd1cd314d7a71777dd9b170f37c7f6d006b277",
        "mu": "c287b55db298b11db6f58f0059dc043db10c16c50ceaf40fad5aa90bfb7dd41e",
        "nu": "66fd0e0c32d573847fb29160cc3af84aa5aa6b64c08870d42b8585ad961f3cac",
        "count": "9d9f290527a6be626a8f5985b26e19b237b44872b03631811df4416fc1713178"},
    "bfloat16": {
        "params": "c4f48e6f51f7414e857f7b06e17e806444953b4c2d37f990b014a70423ac7182",
        "mu": "76241200dca1896799db6e7e35d9ede0c9d5e2139d7d1161b5de84de3f719343",
        "nu": "66fd0e0c32d573847fb29160cc3af84aa5aa6b64c08870d42b8585ad961f3cac",
        "count": "9d9f290527a6be626a8f5985b26e19b237b44872b03631811df4416fc1713178"}}


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_clip_adam_canonical_call_keeps_its_bits(cuda, mu_dtype):
    mu = None if mu_dtype == "float32" else torch.bfloat16
    assert card_cases.adam_digests(torch, ADAM_SHAPES["canonical"], mu) == \
        K9_CANONICAL_DIGESTS[mu_dtype]


def test_clip_adam_launches_two_kernels_and_checks_its_plan(cuda):
    """K9 is two kernel nodes in a captured CUDA graph (its ticket is the
    stream's, so the capture allocates nothing but the call's partials),
    the graph's replays step as the calls do, and its C entry refuses a
    plan that disagrees with the tensors: either chunk table off by one, a
    vec bit on a misaligned pointer (cudaErrorInvalidValue, before any
    launch)."""
    from rainbow_tpu_torch.kernels import adam as k9

    shapes = [(70, 301), (51,), (306,), (9000,)]
    mk = lambda: (_adam_tensors(shapes, "flat_views", torch.float32, cuda,
                                lambda i, s: torch.rand(s, device=cuda)))
    p, g, mu, nu = mk(), mk(), mk(), mk()
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    args = (6.25e-5, 0.9, 0.999, 1.5e-4, 10.0)
    assert _graph_kernels(lambda: clip_adam(p, g, mu, nu, count, *args)) \
        == (2, 2)
    assert int(count) == 1  # the call outside the capture
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        clip_adam(p, g, mu, nu, count, *args)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph, stream=side):
        clip_adam(p, g, mu, nu, count, *args)
    torch.cuda.synchronize()
    clones = [[t.clone() for t in ts] for ts in (p, mu, nu)] + [count.clone()]
    for _ in range(2):
        graph.replay()
        clip_adam(clones[0], g, clones[1], clones[2], clones[3], *args)
    torch.cuda.synchronize()
    for got, want in zip((p, mu, nu), clones):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert int(count) == int(clones[3]) == 4
    numels = [math.prod(s) for s in shapes]
    pointers = [tuple(t.data_ptr() for t in ts) for ts in zip(p, g, mu, nu)]
    plan = k9.adam_plan(numels, pointers, 4)
    scratch = torch.empty(plan.sum_start[-1] + 1, device=cuda)
    ticket = torch.zeros(1, dtype=torch.int32, device=cuda)

    def call(sum_start, update_start, vec):
        t = k9._Table()
        for i, ptrs in enumerate(pointers):
            t.p[i], t.g[i], t.mu[i], t.nu[i] = ptrs
            t.n[i], t.vec[i] = numels[i], vec[i]
        for i in range(len(shapes) + 1):
            t.sum_start[i], t.update_start[i] = sum_start[i], update_start[i]
        t.count = len(shapes)
        return k9._lib()(ctypes.byref(t), scratch.data_ptr(),
                         ticket.data_ptr(), count.data_ptr(), 0, 1,
                         *args[:3],
                         1 - args[1], 1 - args[2], *args[3:],
                         torch.cuda.current_stream().cuda_stream)

    good = (plan.sum_start, plan.update_start, plan.vec)
    assert call(*good) == 0
    for table in (0, 1):
        bumped = list(good[table])
        bumped[1] += 1
        assert call(*good[:table], bumped, *good[table + 1:]) == 1
    misaligned = list(plan.vec)
    assert misaligned[1] == 0
    misaligned[1] = k9.VEC_BITS[0]
    assert call(*good[:2], misaligned) == 1
    torch.cuda.synchronize()
    assert int(count) == 5 and int(ticket) == 0


# The plain-path checks' tolerances by compute dtype: losses (atol, rtol),
# gradients, params after one Adam step, q at the act (atol, rtol), and the
# top-2 gap of q beyond which an action must agree (atol, rtol of the top
# q; in bfloat16 twice q's tolerance: two values each within it of the
# plain ones can swap order only inside it).
# float32: sums of up to 3136 terms in other orders; each gradient tensor
# to 1e-4 of its largest value plus 1e-3 relative, each param to lr/100.
# bfloat16: losses and q to the kernels' bound (6e-2, 3e-2): the plain
# versions round after every op, cuDNN and the kernels once. A gradient
# does not hold elementwise to a share of its tensor's largest value (bf16
# moves single elements of a sum of products that cancel by far more than
# the sum's rounding), so each tensor of the card's bf16 gradient is held
# to the plain path's bf16 gradient on the CPU in norm, as a share of the
# plain gradient's norm (``("norm", {prefix: bound})``), with a bound for
# each kind of tensor from its own readings on the card at
# BF16_UPDATE_SEEDS (PERF.md §6). cuDNN's bf16 convolutions round at other
# points than the CPU's, so the features differ in their last bits, ReLU
# masks flip near zero and the head's p - m cancels: the convolutions'
# gradients read up to 0.130, fc_h_*'s (KA bwd over those features) up to
# 0.139, the head's fc_z_* (K4's gradient, then KA bwd) up to 0.062. A KA
# backward that drops one input chunk (the control) moves fc_h_*'s weight
# gradients by 0.233 or more and fc_z_*'s by 0.636 or more.
# Adam's first step g/(|g| + eps) turns a gradient near zero into a step
# of up to lr either way (a bias of 51 elements has moved by 0.33 of its
# step's norm), so no bound on the params against the plain path's holds
# below 2·lr; instead the card's params are held to the plain clip + Adam
# applied on the CPU to the card's own gradients, to lr/100 as in float32
# (``("refit", 1e-2)``).
PLAIN_TOL = {
    "float32": dict(loss=(1e-4, 1e-4), grad=("max", 1e-4, 1e-3),
                    params=("lr", 1e-2), q=(1e-4, 1e-4), gap=(1e-4, 0.0)),
    "bfloat16": dict(loss=(6e-2, 3e-2),
                     grad=("norm", {"convs.": 0.2, "fc_h_": 0.2,
                                    "fc_z_": 0.1}),
                     params=("refit", 1e-2), q=(6e-2, 3e-2),
                     gap=(1.2e-1, 6e-2)),
}
# The input features a control's KA backward drops: one of the small
# path's input chunks (kernels/noisy_linear.py).
DROPPED_CHUNK = 256
# The seeds of the bf16 update's check, whose readings PLAIN_TOL's bf16
# gradient bounds rest on: one seed's update is one draw of bf16 rounding.
BF16_UPDATE_SEEDS = (16, 116, 216, 316, 416, 516)


def grad_errors(tol, got, want):
    """Each tensor of the card's gradient ``got`` against the plain path's
    ``want`` under ``tol["grad"]`` (PLAIN_TOL): {key: (err, within)}.
    "max": err is the largest |got - want| as a share of the tensor's
    largest |want|, within where every element is within atol (that share)
    + rtol·|want|; "norm": err is ‖got - want‖ as a share of ‖want‖,
    within the bound of the key's prefix."""
    how, *g_tol = tol["grad"]
    out = {}
    for k, w in want.items():
        w = w.float()
        d = (got[k].float() - w).abs()
        if how == "max":
            scale = max(float(w.abs().max()), 1e-30)
            within = bool((d <= g_tol[0] * scale + g_tol[1] * w.abs()).all())
            out[k] = (float(d.max()) / scale, within)
        else:
            bound, = (v for p, v in g_tol[0].items() if k.startswith(p))
            err = float(d.norm()) / max(float(w.norm()), 1e-30)
            out[k] = (err, err <= bound)
    return out


def _check_update_against_plain(cfg, seed, monkeypatch):
    """One learner update of ``cfg``'s net (compute_update_pretarget +
    apply_grads) through the kernels on the card and through the plain
    versions on the CPU, from the same params (from ``seed``), batch,
    target distribution and shared noise, within PLAIN_TOL of its compute
    dtype, every param moved by more than the params' tolerance; the card's
    update launches each kernel as often as one update needs (KA's
    backward on its large path where bwd_plan says so), the CPU's none.
    Then a control the gradient check must refuse: the card's update again
    with KA's backward given x without its first DROPPED_CHUNK input
    features, as a kernel that dropped one input chunk would compute it;
    every noisy layer's weight gradients must fail grad_errors."""
    from rainbow_tpu_torch.kernels import noisy_linear as ka
    from rainbow_tpu_torch.models.dqn import NOISY_LAYERS, _noisy_dims

    tol = PLAIN_TOL[cfg.compute_dtype]
    b = cfg.batch_size
    rng = np.random.default_rng(seed - 1)
    params = init_dqn_params(cfg, N_ACT, seed, "cpu")
    u8 = lambda: rng.integers(0, 256, (b, 84, 84, cfg.history_length))
    batch = {"states": torch.from_numpy(u8().astype(np.float32) / 255),
             "next_states": torch.from_numpy(u8().astype(np.float32) / 255),
             "actions": torch.from_numpy(rng.integers(0, N_ACT, b)
                                         .astype(np.int32)),
             "returns": torch.from_numpy(rng.uniform(-2, 2, b)
                                         .astype(np.float32)),
             "nonterminals": torch.from_numpy((rng.random(b) > 0.2)
                                              .astype(np.float32)),
             "weights": torch.from_numpy(rng.uniform(0.2, 1, b)
                                         .astype(np.float32))}
    pns = torch.from_numpy(rng.dirichlet(np.ones(cfg.atoms), (b, N_ACT))
                           .astype(np.float32))
    noise = draw_noise(cfg, N_ACT, NoiseStream(seed + 1), device="cpu")

    def update(dev, apply=True):
        p = {k: v.to(dev).clone() for k, v in params.items()}
        agent = ag.AgentState(
            params=p, target_params={k: v.clone() for k, v in p.items()},
            opt_state=ag.init_adam(p, cfg),
            generator=torch.Generator(device=dev))
        reset_launches()
        grads, losses = ag.compute_update_pretarget(
            agent, cfg, N_ACT, {k: v.to(dev) for k, v in batch.items()},
            pns.to(dev), {k: (x.to(dev), y.to(dev))
                          for k, (x, y) in noise.items()})
        if apply:
            ag.apply_grads(agent, cfg, grads)
        return (losses.cpu().float(), {k: v.cpu() for k, v in grads.items()},
                {k: v.cpu() for k, v in agent.params.items()}, launches())

    out = {dev: update(dev) for dev in ("cuda", "cpu")}
    dims = _noisy_dims(cfg, N_ACT)
    dt = getattr(torch, cfg.compute_dtype)
    large = sum(bwd_plan(b, *dims[n], 1, dt).path == "large"
                for n in NOISY_LAYERS)
    assert out["cuda"][3] == dict(
        dict.fromkeys(LAUNCHES, 0), noisy_linear_fwd=8, dueling_head=1,
        c51_target=1, head_loss=1, noisy_linear_bwd=4,
        noisy_linear_bwd_large=large, clip_adam=1)
    assert out["cpu"][3] == dict.fromkeys(LAUNCHES, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0],
                               atol=tol["loss"][0], rtol=tol["loss"][1])
    grads = grad_errors(tol, out["cuda"][1], out["cpu"][1])
    readings = {k: err for k, (err, _) in grads.items()}
    assert all(within for _, within in grads.values()), readings
    how, share = tol["params"]
    if how == "refit":
        p = {k: v.clone() for k, v in params.items()}
        agent = ag.AgentState(params=p, target_params=p,
                              opt_state=ag.init_adam(p, cfg),
                              generator=torch.Generator())
        ag.apply_grads(agent, cfg, out["cuda"][1])
        out["cpu"] = out["cpu"][:2] + (agent.params, out["cpu"][3])
    p_tol = cfg.learning_rate * share
    for k, want in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][k], want, atol=p_tol,
                                   rtol=0, msg=k)
        assert float((want - params[k]).abs().max()) > p_tol, k
    real = ka.noisy_linear_bwd

    def dropped(w_mu, w_sig, x, g, eps=None, y=None):
        x = x.clone()
        x[:, :DROPPED_CHUNK] = 0
        return real(w_mu, w_sig, x, g, eps, y)

    with monkeypatch.context() as m:
        m.setattr(ka, "noisy_linear_bwd", dropped)
        bad = update("cuda", apply=False)[1]
    control = grad_errors(tol, bad, out["cpu"][1])
    for k in (f"{n}.{w}" for n in NOISY_LAYERS
              for w in ("weight_mu", "weight_sigma")):
        assert not control[k][1], (k, control[k][0], readings)


# One learner update of each full-size configuration, the bf16 one at each
# of BF16_UPDATE_SEEDS.
UPDATE_CASES = {
    f"update-{label}-seed{seed}": (cfg, seed) for label, cfg in CONFIGS
    for seed in (BF16_UPDATE_SEEDS if cfg.compute_dtype == "bfloat16"
                 else (16,))}
# One learner update of each benchmark cell at its batch, on the card alone
# (_update_on_card): at 1,024 float32 rows the CPU's and cuDNN's sums of
# the first convolution's gradients over 409,600 terms each differ by more
# than PLAIN_TOL's 1e-4 of the largest, which holds at the presets' 32 and
# 256 rows.
CELL_UPDATES = {f"update-{name}": cfg for name, cfg in CELLS}


@pytest.mark.parametrize("case", ["round", *UPDATE_CASES, *CELL_UPDATES])
def test_learner_round_on_card_matches_cpu(cuda, case, monkeypatch):
    """One learner round through the kernels and through the plain versions
    on the CPU, with the same replay, params and draws; the kernels launch
    the counts the round needs. And (update-*) one learner update of each
    full-size configuration against the plain path
    (_check_update_against_plain), and one of each benchmark cell at its
    batch on the card, its kernels against their plain versions there
    (_update_on_card)."""
    if case in UPDATE_CASES:
        _check_update_against_plain(*UPDATE_CASES[case], monkeypatch)
        return
    if case in CELL_UPDATES:
        _update_on_card(CELL_UPDATES[case], cuda)
        return
    cfg = rainbow_tpu_torch.canonical(num_envs=4, memory_capacity=128,
                                      hidden_size=32, batch_size=4)
    n_act, nl = 3, 2
    rng = np.random.default_rng(7)
    base = rp.init_replay(4, 32, 84, "cpu")
    base.frames.copy_(torch.from_numpy(rng.integers(0, 256, base.frames.shape,
                                                    np.uint8)))
    base.timesteps.copy_(torch.from_numpy(rng.integers(0, 5, (4, 32),
                                                       np.int32)))
    base.rewards.copy_(torch.from_numpy(rng.normal(size=(4, 32))
                                        .astype(np.float32)))
    base.nonterminal.fill_(True)
    base.priorities.copy_(torch.from_numpy(rng.gamma(2.0, 1.0, (4, 32))
                                           .astype(np.float32)))
    base.index.fill_(9)
    base.full.fill_(True)
    gen, ns = torch.Generator().manual_seed(8), NoiseStream(8)
    draws = {"u": torch.rand(nl * 4, generator=gen),
             "target": draw_noise(cfg, n_act, ns, (nl * 4,), "cpu"),
             "online": draw_noise(cfg, n_act, ns, (nl,), "cpu")}
    out = {}
    for dev in ("cuda", "cpu"):
        agent = ag.init_agent(cfg, n_act, 0, "cpu")
        agent = ag.AgentState(
            params={k: v.to(dev) for k, v in agent.params.items()},
            target_params={k: v.to(dev) for k, v in
                           agent.target_params.items()},
            opt_state=ag.init_adam({k: v.to(dev) for k, v in
                                    agent.params.items()}, cfg),
            generator=torch.Generator(device=dev))
        rep = rp.ReplayState(**{f.name: getattr(base, f.name).to(dev).clone()
                                for f in dataclasses.fields(base)})
        d = {"u": draws["u"].to(dev),
             **{k: {n: (x.to(dev), y.to(dev)) for n, (x, y) in
                    draws[k].items()} for k in ("target", "online")}}
        reset_launches()
        loss = ttrain.learner_round(agent, rep, cfg, n_act, nl, 0.5, d)
        out[dev] = (float(loss), agent, rep, launches())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    # Params to lr/100: a gradient that differs by summation order moves an
    # Adam step by at most lr·Δg/eps, and by far less where |g| ≫ eps.
    # Every tensor moved by more than that.
    tol = 6.25e-5 / 100
    params0 = ag.init_agent(cfg, n_act, 0, "cpu").params
    for k, v in out["cpu"][1].params.items():
        torch.testing.assert_close(out["cuda"][1].params[k].cpu(), v,
                                   atol=tol, rtol=0)
        assert float((v - params0[k]).abs().max()) > tol, k
    torch.testing.assert_close(out["cuda"][2].priorities.cpu(),
                               out["cpu"][2].priorities, atol=1e-4, rtol=1e-4)
    assert out["cuda"][3] == dict(
        dict.fromkeys(LAUNCHES, 0), noisy_linear_fwd=4 + 8 * nl,
        dueling_head=1 + nl, noisy_linear_bwd=4 * nl, c51_target=nl,
        head_loss=nl, clip_adam=nl, stratified_sample=1, gather_window=1,
        write_priorities=1)
    assert out["cpu"][3] == dict.fromkeys(LAUNCHES, 0)


def _card_ring(dev, e, c, index, full, n_hot=0, empty=False, seed=9):
    """A random ring on ``dev``: episode starts about every 6 steps, some
    zero priorities, and ``n_hot`` leaves with most of the mass, so that
    stratified draws repeat them."""
    rng = np.random.default_rng(seed)
    starts = rng.random((e, c)) < 0.17
    ts = np.zeros((e, c), np.int32)
    for j in range(1, c):
        ts[:, j] = np.where(starts[:, j - 1], 0, ts[:, j - 1] + 1)
    pr = rng.gamma(2.0, 1.0, (e, c)).astype(np.float32)
    pr[rng.random((e, c)) < 0.1] = 0.0
    pr.reshape(-1)[rng.choice(e * c, n_hot, replace=False)] = 1e3 * e * c
    if empty:
        pr[:] = 0.0
    rep = rp.init_replay(e, c, 84, "cpu")
    rep.frames.copy_(torch.from_numpy(rng.integers(0, 256, rep.frames.shape,
                                                   np.uint8)))
    rep.actions.copy_(torch.from_numpy(rng.integers(0, 6, (e, c),
                                                    np.int32)))
    rep.rewards.copy_(torch.from_numpy(rng.normal(size=(e, c))
                                       .astype(np.float32)))
    rep.timesteps.copy_(torch.from_numpy(ts))
    rep.nonterminal.copy_(torch.from_numpy(rng.random((e, c)) > 0.1))
    rep.priorities.copy_(torch.from_numpy(pr))
    rep.index.fill_(index)
    rep.full.fill_(full)
    rep.max_priority.fill_(float(max(pr.max(), 1.0)))
    return rp.ReplayState(**{f.name: getattr(rep, f.name).to(dev)
                             for f in dataclasses.fields(rep)})


def check_write_back(rep0, kern, plain, draw_idx, idxs, p):
    """K7 against its plain version: untouched and once-written leaves
    exact, every repeated leaf holds the value of the last draw of its run
    (draw order), and the max is exact."""
    n = rep0.priorities.numel()
    flat = idxs.reshape(-1)
    counts = torch.bincount(flat, minlength=n)
    got, want = kern.priorities.view(-1), plain.priorities.view(-1)
    assert torch.equal(got[counts == 0], rep0.priorities.view(-1)[counts == 0])
    assert torch.equal(got[counts == 1], want[counts == 1])
    nb, bs = idxs.shape
    j = torch.arange(nb * bs, device=flat.device)
    p_draw = p[j % nb, j // nb]
    last = torch.ones_like(draw_idx, dtype=torch.bool)
    last[:-1] = draw_idx[1:] != draw_idx[:-1]
    assert torch.equal(got[draw_idx[last]], p_draw[last])
    assert torch.equal(kern.max_priority, plain.max_priority)
    return int((counts > 1).sum())


REPLAY_CASES = {
    # (E, C, index, full, n_step, num_batches, batch_size, hot leaves, empty,
    # ties). K5's tree depths: round and throughput 16 (a first step of one
    # level, three stored levels), window_24 11, depth_7 7 (one stored
    # level), n_le_32 5 (none: the leaves alone). ties: priorities of one
    # and u = 0, so that every draw's value is a left sum exactly.
    # data_efficient: the preset's whole ring, 16 envs x 6,250 columns
    # (100,000 leaves, depth 17), its round of 16 batches of 32 with a
    # window of 4 + 20 frames.
    "round": (64, 976, 500, True, 3, 16, 32, 3, False, False),
    "data_efficient": (16, 6250, 500, True, 20, 16, 32, 3, False, False),
    "throughput": (64, 976, 500, True, 3, 4, 256, 0, False, False),
    "window_24": (16, 128, 70, True, 20, 8, 32, 0, False, False),
    "after_wrap": (32, 61, 0, True, 3, 8, 16, 2, False, False),
    "head_at_last": (32, 61, 60, True, 3, 8, 16, 0, False, False),
    "partial": (32, 61, 40, False, 3, 8, 16, 0, False, False),
    "empty": (8, 61, 30, False, 3, 2, 16, 0, True, False),
    "depth_7": (4, 30, 12, True, 3, 4, 8, 0, False, False),
    "n_le_32": (2, 13, 5, True, 3, 2, 4, 0, False, False),
    "b1": (64, 976, 500, True, 3, 1, 1, 0, False, False),
    "b32": (64, 976, 500, True, 3, 1, 32, 0, False, False),
    "ties": (64, 16, 8, True, 3, 18, 32, 0, False, True),
    # K6 at the data-efficient round's window of 24 (16 x 32) and the
    # throughput round's window of 7 (32 x 256).
    "window_24_nb16": (16, 300, 120, True, 20, 16, 32, 0, False, False),
    "window_7_nb32_bs256": (64, 976, 500, True, 3, 32, 256, 0, False, False),
    # The data-efficient preset's ring just after a wrap, partly filled and
    # empty, at its round.
    "data_efficient_after_wrap": (16, 6250, 0, True, 20, 16, 32, 0, False,
                                  False),
    "data_efficient_partial": (16, 6250, 4000, False, 20, 16, 32, 0, False,
                               False),
    "data_efficient_empty": (16, 6250, 321, False, 20, 16, 32, 0, True,
                             False),
    # The canonical ring (1,024 envs x 976 columns, 7.05 GB of frames, so
    # frame offsets past 2^32 bytes; depth 20) at the canonical round, the
    # throughput preset's, a window of 24, empty and just after a wrap.
    "canonical_round": (1024, 976, 500, True, 3, 256, 32, 3, False, False),
    "canonical_throughput": (1024, 976, 500, True, 3, 32, 256, 0, False,
                             False),
    "canonical_window_24": (1024, 976, 321, True, 20, 256, 32, 0, False,
                            False),
    "canonical_empty": (1024, 976, 321, False, 3, 256, 32, 0, True, False),
    "canonical_after_wrap": (1024, 976, 0, True, 3, 256, 32, 0, False,
                             False),
}


def _canonical_ring(dev, index, full, n_hot=0, empty=False, seed=20):
    """The canonical ring (1,024 x 976) drawn on the card by a torch
    generator, as _card_ring draws its small rings: episode starts
    (timestep 0) about one step in six, some zero priorities, and ``n_hot``
    leaves that hold a third of the mass each."""
    e, c = 1024, 976
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda: torch.rand((e, c), generator=g, device=dev)
    rep = rp.init_replay(e, c, 84, dev)
    rep.frames.random_(0, 256, generator=g)
    rep.actions.random_(0, 6, generator=g)
    rep.rewards.normal_(generator=g)
    rep.timesteps.random_(0, 6, generator=g)
    rep.nonterminal.copy_(rand() > 0.1)
    pr = -torch.log(rand() * rand())
    pr[rand() < 0.1] = 0.0
    hot = torch.randperm(e * c, generator=g, device=dev)[:n_hot]
    pr.view(-1)[hot] = float(pr.sum()) / 3
    if empty:
        pr.zero_()
    rep.priorities.copy_(pr)
    rep.index.fill_(index)
    rep.full.fill_(full)
    rep.max_priority.fill_(max(float(pr.max()), 1.0))
    return rep


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_replay_kernels_match_plain(cuda, case):
    """K5, K6 and K7 against their plain versions on the rings of
    REPLAY_CASES: K5 bit-exact in the launches its plan counts, K6's
    frames, actions and nonterminals exact and its returns and weights
    within 1e-6, K7 by check_write_back; a second launch of each gives the
    same bits."""
    e, c, index, full, n, nb, bs, hot, empty, ties = REPLAY_CASES[case]
    if e == 1024:
        rep = _canonical_ring(cuda, index, full, hot, empty)
    else:
        rep = _card_ring(cuda, e, c, index, full, hot, empty)
    g = torch.Generator(device=cuda).manual_seed(10)
    u = torch.rand(nb * bs, generator=g, device=cuda)
    if ties:
        rep.priorities.fill_(1.0)
        u.zero_()
    reset_launches()
    idx, p, total = k_replay.stratified_sample(rep, u, 4, n)
    want = rp.stratified_sample_plain(rep, u, 4, n)
    for a, b in zip((idx, p, total), want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    again = k_replay.stratified_sample(rep, u, 4, n)
    for a, b in zip((idx, p, total), again):
        assert torch.equal(a, b)
    if ties:  # 9 unmasked columns a row: total = B, every value j exact
        assert float(total) == nb * bs == e * (c - 7)
    got = k_replay.gather_window(rep, idx, p, total, 0.6, nb, bs, 4, n, 0.99)
    want = rp.gather_window_plain(rep, idx, p, total, 0.6, nb, bs, 4, n,
                                  0.99)
    assert got.keys() == want.keys()
    for k in ("idxs", "states", "next_states", "actions", "nonterminals"):
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    for k in ("returns", "weights", "weights_max"):
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-6)
    if empty:
        assert torch.equal(got["weights"], torch.zeros_like(got["weights"]))
    losses = torch.rand((nb, bs), generator=g, device=cuda) * 5
    kern, plain = (rp.ReplayState(**{
        f.name: getattr(rep, f.name).clone()
        for f in dataclasses.fields(rep)}) for _ in range(2))
    k_replay.write_priorities(kern, got["idxs"], losses, 0.5)
    rp.update_priorities_plain(plain, got["idxs"], losses, 0.5)
    repeated = check_write_back(rep, kern, plain, idx, got["idxs"],
                                losses ** 0.5)
    # Adjacent draws share a leaf that straddles a segment boundary; hot
    # leaves and an empty ring repeat leaves for certain.
    assert repeated > 0 or not (hot or empty)
    assert launches() == dict(dict.fromkeys(LAUNCHES, 0),
                              stratified_sample=2, gather_window=1,
                              write_priorities=1)
    again = k_replay.gather_window(rep, idx, p, total, 0.6, nb, bs, 4, n,
                                   0.99)
    assert all(torch.equal(got[k], again[k]) for k in got)
    second = dataclasses.replace(rep, priorities=rep.priorities.clone(),
                                 max_priority=rep.max_priority.clone())
    k_replay.write_priorities(second, got["idxs"], losses, 0.5)
    assert same_bits(second.priorities, kern.priorities)
    assert same_bits(second.max_priority, kern.max_priority)
    plan = k_replay.tree_plan(e * c)
    assert plan.launches <= 2
    assert _graph_kernels(lambda: k_replay.stratified_sample(
        rep, u, 4, n)) == (plan.launches, plan.launches)


def same_bits(a, b):
    """Equal bits, or NaN in both."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


# K7 alone: (nb, bs, runs of one leaf in draw order as [start, stop),
# special). B = 1 to 8192 in ragged layouts; runs inside one block of 256
# threads and across a block edge (batch order puts draws j and j + 1 bs
# elements apart: draws 5..12 of the round straddle batches 7 and 8, draws
# 250..260 wrap to the next row); the whole round on one leaf; a NaN loss
# inside a run and at the round; a -0.0 loss; an empty ring (all mass 0,
# so K5 puts every draw on one leaf); an old max_priority that is a NaN with
# its sign bit set, which stays NaN.
K7_CASES = {
    "b1": (1, 1, (), None),
    "b31_run": (1, 31, ((3, 9),), None),
    "b32": (1, 32, (), None),
    "b33": (3, 11, ((0, 4),), None),
    "b255": (15, 17, ((100, 120),), None),
    "b256": (8, 32, ((0, 256),), None),
    "b257_across_edge": (1, 257, ((250, 257),), None),
    "round": (256, 32, ((1, 4), (5, 13), (250, 261)), None),
    "round_hot_leaf": (256, 32, ((0, 8192),), None),
    "round_nan_loss": (256, 32, ((5, 13),), "nan"),
    "b32_nan_loss_in_a_run": (1, 32, ((3, 9),), "nan"),
    "b32_negative_zero": (1, 32, (), "-0"),
    "round_empty_ring": (256, 32, (), "empty"),
    "round_old_negative_nan": (256, 32, (), "old_negative_nan"),
}


@pytest.mark.parametrize("case", list(K7_CASES))
def test_write_priorities_kernel_matches_plain_bit_for_bit(cuda, case):
    """K7 against update_priorities_plain on the card: once-drawn leaves
    and untouched leaves hold the plain version's bits, each leaf drawn by
    a run holds its last draw's priority, and max_priority the plain
    version's bits; a NaN loss makes max_priority NaN, as torch.maximum
    and JAX's jnp.maximum do. One launch a call."""
    nb, bs, runs, special = K7_CASES[case]
    b = nb * bs
    g = torch.Generator(device=cuda).manual_seed(len(case))
    rep = rp.init_replay(64, 976, 1, cuda)  # priorities alone
    pr = -torch.log(torch.rand((64, 976), generator=g, device=cuda))
    pr[torch.rand((64, 976), generator=g, device=cuda) < 0.1] = 0.0
    rep.priorities.copy_(pr * (special != "empty"))
    rep.max_priority.fill_(float(pr.max()))
    if special == "old_negative_nan":  # what x86 makes of 0·inf
        rep.max_priority.view(torch.int32).fill_(-0x400000)
    rep.index.fill_(500)
    rep.full.fill_(True)
    n = rep.priorities.numel()
    if special == "empty":
        draw, _, _ = k_replay.stratified_sample(
            rep, torch.rand(b, generator=g, device=cuda), 4, 3)
        assert draw.unique().numel() == 1
    else:
        draw = torch.sort(torch.randint(0, n, (b,), generator=g,
                                        device=cuda)).values
    for a, z in runs:  # still nondecreasing: draw[a] <= draw[z]
        draw[a:z] = draw[a].clone()
    loss_draw = torch.rand(b, generator=g, device=cuda) * 5
    if special == "nan":
        loss_draw[6] = float("nan")  # inside the run, not its last draw
    if special == "-0":
        loss_draw[7] = -0.0
    idxs = draw.view(bs, nb).T.contiguous()
    losses = loss_draw.view(bs, nb).T.contiguous()
    kern, plain = (dataclasses.replace(
        rep, priorities=rep.priorities.clone(),
        max_priority=rep.max_priority.clone()) for _ in range(2))
    reset_launches()
    k_replay.write_priorities(kern, idxs, losses, 0.5)
    assert launches() == dict(dict.fromkeys(LAUNCHES, 0), write_priorities=1)
    rp.update_priorities_plain(plain, idxs, losses, 0.5)
    assert same_bits(kern.max_priority, plain.max_priority)
    assert bool(torch.isnan(kern.max_priority)) == (
        special in ("nan", "old_negative_nan"))
    want = rep.priorities.clone().view(-1)
    last = torch.ones(b, dtype=torch.bool, device=cuda)
    last[:-1] = draw[1:] != draw[:-1]
    want[draw[last]] = (loss_draw ** 0.5)[last]
    got = kern.priorities.view(-1)
    assert same_bits(got, want)
    once = torch.bincount(draw, minlength=n) <= 1
    assert same_bits(got[once], plain.priorities.view(-1)[once])
    if special == "-0":  # sqrt(-0.0) is -0.0, as torch.pow gives
        assert int(got[draw[7]].view(torch.int32)) == -2 ** 31


def test_gather_window_launches_one_kernel_and_checks_its_plan(cuda):
    """K6 is one kernel node in a captured CUDA graph, at windows of 7 and
    24, and its C entry refuses a grid that is not gather_plan's before any
    launch."""
    rep = _card_ring(cuda, 16, 300, 120, True)
    for nb, bs, n in ((16, 32, 20), (32, 256, 3)):
        u = torch.rand(nb * bs, device=cuda)
        idx, p, total = k_replay.stratified_sample(rep, u, 4, n)
        assert _graph_kernels(lambda: k_replay.gather_window(
            rep, idx, p, total, 0.6, nb, bs, 4, n, 0.99)) == (1, 1)
        outs = [torch.empty(nb * bs, dtype=dt, device=cuda) for dt in (
            torch.int64, torch.int32, torch.float32, torch.float32,
            torch.float32)] + [torch.empty(nb, device=cuda),
                               torch.empty(nb * bs * (4 + n) * 7056,
                                           dtype=torch.uint8, device=cuda)]
        blocks = k_replay.gather_plan(nb, bs, 4 + n).blocks
        for grid, rc in ((blocks - 1, 1), (blocks + 1, 1), (blocks, 0)):
            assert k_replay._lib().gather_window(
                rep.frames.data_ptr(), rep.actions.data_ptr(),
                rep.rewards.data_ptr(), rep.timesteps.data_ptr(),
                rep.nonterminal.data_ptr(), rep.index.data_ptr(),
                rep.full.data_ptr(), 16, 300, 7056, idx.data_ptr(),
                p.data_ptr(), total.data_ptr(), 4, n, 0.99, 0.6, nb, bs,
                grid, *(t.data_ptr() for t in outs),
                torch.cuda.current_stream().cuda_stream) == rc, grid
    torch.cuda.synchronize()


def test_write_priorities_launches_one_kernel_and_checks_its_plan(cuda):
    """K7 is one kernel node in a captured CUDA graph, at the round and at
    B = 32, and its C entry refuses a grid that does not cover the draws
    exactly (cudaErrorInvalidValue) before any launch."""
    rep = _card_ring(cuda, 8, 61, 30, True)
    for nb, bs in ((256, 32), (1, 32)):
        idxs = torch.randint(0, 8 * 61, (nb, bs), device=cuda)
        losses = torch.rand((nb, bs), device=cuda)
        assert _graph_kernels(lambda: k_replay.write_priorities(
            rep, idxs, losses, 0.5)) == (1, 1)
        blocks = k_replay.write_blocks(nb * bs)
        for grid, rc in ((blocks - 1, 1), (blocks + 1, 1), (blocks, 0)):
            assert k_replay._lib().write_priorities(
                idxs.data_ptr(), losses.data_ptr(), nb, bs, 0.5, grid,
                rep.priorities.data_ptr(), rep.max_priority.data_ptr(),
                torch.cuda.current_stream().cuda_stream) == rc, grid
    torch.cuda.synchronize()


def _k5_cases():
    """K5 alone on rings of priorities alone (frames of one byte), as
    (depth, E, C, write head, history, n-step, B, priorities): trees whose
    padded leaf count is 2^20 (the canonical ring's), 2^21 and 2^22 (four
    stored levels), half padded, at B = 1, 32 and 8192, and nearly full at
    8192; trees of depth 0, 1, 4 and 5 (no stored level) and 7 (one) at
    other histories and n-steps; ties (ones and u = 0, so that every value
    (j + 0)·total/B with B the count of unmasked leaves is a left sum
    exactly) at two draws a segment; an empty canonical ring."""
    cases = {f"depth_{d}_b{b}": (d, (1 << (d - 1)) // 1000 + 1, 1000, 321, 4,
                                 3, b, "gamma")
             for d in (20, 21, 22) for b in (1, 32, 8192)}
    cases.update({
        "depth_21_full": (21, 2048, 1000, 500, 4, 3, 8192, "gamma"),
        "depth_22_full": (22, 4096, 1000, 999, 4, 3, 8192, "gamma"),
        "depth_0": (0, 1, 1, 0, 4, 3, 4, "gamma"),
        "depth_1": (1, 1, 2, 0, 1, 0, 5, "gamma"),
        "depth_4": (4, 2, 8, 3, 4, 1, 32, "gamma"),
        "depth_5_b1": (5, 3, 9, 4, 2, 1, 1, "gamma"),
        "depth_7": (7, 5, 20, 7, 4, 3, 32, "gamma"),
        "ties_seg_2": (10, 64, 16, 8, 4, 3, 288, "ones"),
        "empty_depth_20": (20, 1024, 976, 500, 4, 3, 8192, "zeros")})
    return cases


K5_CASES = _k5_cases()


@pytest.mark.parametrize("case", list(K5_CASES))
def test_stratified_sample_kernel_on_deep_trees(cuda, case):
    """K5 on the rings of K5_CASES: the plain version's bits, twice; the
    kernels its plan counts (two with a stored level, else one), and no
    allocation but the three outputs."""
    depth, e, c, index, history, n, b, prio = K5_CASES[case]
    rep = rp.init_replay(e, c, 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(depth)
    if prio == "gamma":
        pr = -torch.log(torch.rand((e, c), generator=g, device=cuda))
        pr[torch.rand((e, c), generator=g, device=cuda) < 0.1] = 0.0
        rep.priorities.copy_(pr)
    elif prio == "ones":
        rep.priorities.fill_(1.0)
    rep.index.fill_(index)
    rep.full.fill_(True)
    plan = k_replay.tree_plan(e * c)
    assert plan.depth == depth and plan.launches <= 2
    u = (torch.zeros(b, device=cuda) if prio == "ones"
         else torch.rand(b, generator=g, device=cuda))
    want = rp.stratified_sample_plain(rep, u, history, n)
    for _ in range(2):
        got = k_replay.stratified_sample(rep, u, history, n)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and torch.equal(a, w)
    if prio == "ones":
        assert float(want[2]) == e * (c - history - n)
    del got
    assert _graph_kernels(lambda: k_replay.stratified_sample(
        rep, u, history, n)) == (plan.launches, plan.launches)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = k_replay.stratified_sample(rep, u, history, n)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - before \
        == 3
    del out


def test_kept_buffers_are_per_stream(cuda):
    """K5's tree levels and ticket and KC's ticket are kept per stream: K5
    launched on two streams at once gives the plain version's bits on
    both, and a stream's first call under graph capture raises instead of
    capturing an allocation."""
    from rainbow_tpu_torch.kernels import device_buffer

    rep = rp.init_replay(600, 1000, 1, cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    rep.priorities.copy_(-torch.log(torch.rand((600, 1000), generator=g,
                                               device=cuda)))
    rep.index.fill_(77)
    rep.full.fill_(True)
    u = torch.rand(8192, generator=g, device=cuda)
    want = rp.stratified_sample_plain(rep, u, 4, 3)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    bufs = []
    for st in streams:
        with torch.cuda.stream(st):
            bufs.append(device_buffer("stratified_sample levels", cuda,
                                      k_replay.SCRATCH, torch.float32))
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(3):
        for st in streams:
            with torch.cuda.stream(st):
                got.append(k_replay.stratified_sample(rep, u, 4, 3))
    torch.cuda.synchronize()
    for out in got:
        for a, w in zip(out, want):
            assert torch.equal(a, w)
    # A stream no kernel has run on, made here: PyTorch's pools hand their
    # streams out in turn, and earlier tests may have run K5 on any of them.
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p()
    assert drv.cuStreamCreate(ctypes.byref(handle), 1) == 0  # non-blocking
    try:
        fresh = torch.cuda.ExternalStream(handle.value)
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="under CUDA graph capture"):
            with torch.cuda.graph(graph, stream=fresh):
                k_replay.stratified_sample(rep, u, 4, 3)
        del graph
    finally:
        torch.cuda.synchronize()
        assert drv.cuStreamDestroy_v2(handle) == 0


def test_replay_and_append_kernels_refuse_a_plan_that_disagrees(cuda):
    """The C entries run with the wrappers' plans and check them: a depth,
    a stored count or an offset of K5's plan that disagrees with the ring,
    or a KC grid that does not cover the items exactly, is refused
    (cudaErrorInvalidValue) before any launch; misaligned priorities make
    K5's wrapper raise."""
    import ctypes

    from rainbow_tpu_torch.kernels import append_framestack as kc

    rep = rp.init_replay(40, 100, 1, cuda)  # 4000 leaves: depth 12
    u = torch.rand(32, device=cuda)
    out = [torch.empty(32, dtype=torch.int64, device=cuda),
           torch.empty(32, device=cuda), torch.empty((), device=cuda)]
    levels = torch.zeros(k_replay.SCRATCH, device=cuda)
    ticket = torch.zeros(1, dtype=torch.int32, device=cuda)
    plan = k_replay.tree_plan(4000)
    assert (plan.depth, plan.offsets) == (12, (0, 128))

    def k5(depth, stored, offsets):
        off = (ctypes.c_int * k_replay.MAX_STORED)(*offsets)
        return k_replay._lib().stratified_sample(
            rep.priorities.data_ptr(), rep.index.data_ptr(), 40, 100, 4, 3,
            u.data_ptr(), 32, depth, stored, off, levels.data_ptr(),
            ticket.data_ptr(), *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream)

    reset_launches()
    assert k5(12, 2, (0, 128)) == 0
    torch.cuda.synchronize()
    for bad in ((11, 2, (0, 64)), (13, 2, (0, 256)), (12, 1, (0,)),
                (12, 2, (0, 127))):
        assert k5(*bad) == 1, bad  # cudaErrorInvalidValue
    bumped = torch.zeros(4001, device=cuda)[1:].view(40, 100)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k_replay.stratified_sample(dataclasses.replace(
            rep, priorities=bumped), u, 4, 3)

    n, p = 10, 84 * 84
    stack = torch.zeros((n, 84, 84, 4), dtype=torch.uint8, device=cuda)
    obs = torch.zeros((n, 84, 84), dtype=torch.uint8, device=cuda)
    ridx = torch.zeros(0, dtype=torch.int32, device=cuda)
    kinds = torch.zeros(n, dtype=torch.uint8, device=cuda)
    blocks = kc.launch_plan(n, p, 4).blocks
    for grid, rc in ((blocks, 0), (blocks - 1, 1), (blocks + 1, 1)):
        assert kc._lib()(stack.data_ptr(), obs.data_ptr(), obs.data_ptr(),
                         ridx.data_ptr(), 0, kinds.data_ptr(), n, p, 4, 1,
                         grid, *([None] * 10), 0, None, None, None, 0.0,
                         None, torch.cuda.current_stream().cuda_stream) \
            == rc, grid
    torch.cuda.synchronize()
    assert launches()["stratified_sample"] == 0


def _noise_cases():
    """K2's launches, {id: shapes}: eight ragged tensors (none a multiple of
    4 long) with no, 5 and 33 leading rows; then the draws of each
    configuration and cell (noise_shapes: models.dqn.draw_noise's eight
    tensors per leading shape), each once: the act's over its envs, the
    batched round's (its target rows and one online draw per update, in
    one launch) and the sequential update's (online and target, shared)."""
    cases = {f"lead{i}": [lead + (d,) for d in (301, 70, 301, 70, 70, 51,
                                                 70, 153)]
             for i, lead in enumerate([(), (5,), (33,)])}
    for label, c in CONFIGS + CELLS:
        nb = c.num_envs // c.replay_frequency
        for name, leads in (("act", [(c.num_envs,)]),
                            ("round", [(nb * c.batch_size,), (nb,)]),
                            ("sequential", [(), ()])):
            shapes = card_cases.noise_shapes(c, N_ACT, leads)
            if shapes not in cases.values():
                cases[f"{label}-{name}"] = shapes
    return cases


NOISE_CASES = _noise_cases()


@pytest.mark.parametrize("case", list(NOISE_CASES))
def test_noise_kernel_matches_plain(cuda, case):
    """K2 against philox_noise_plain on the card (and, for the ragged
    tensors, on the CPU), at NOISE_CASES' shapes in one launch, at an
    offset and a seed beyond 32 bits; the tensors are 16-byte aligned
    views of one buffer. The 71 M target draws of a round of 8,192 rows
    have |mean| < 1e-3 and |E[eps^2] - sqrt(2/pi)| < 1e-3 (their sampling
    errors are about 1.1e-4 and 7e-5)."""
    shapes = NOISE_CASES[case]
    for seed, offset in ((0, 0), (2 ** 40 + 5, 4 * 12345)):
        reset_launches()
        got = scaled_noise(seed, offset, shapes, cuda)
        assert launches()["scaled_noise"] == 1
        storage = got[0].untyped_storage().data_ptr()
        assert all(t.untyped_storage().data_ptr() == storage
                   and t.data_ptr() % 16 == 0 and t.is_contiguous()
                   for t in got)
        wants = [philox_noise_plain(seed, offset, shapes, cuda)]
        if case.startswith("lead"):
            wants.append(philox_noise_plain(seed, offset, shapes))
        for want in wants:
            for a, b in zip(got, want):
                b = b.to(cuda)
                assert a.dtype == torch.float32 and a.shape == b.shape
                torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
                assert torch.equal(torch.sign(a), torch.sign(b))
        if shapes[0][0] == 8192:
            flat = torch.cat([x.reshape(-1) for x in got[:8]]).double()
            mean, square = float(flat.mean()), float((flat * flat).mean())
            assert abs(mean) < 1e-3 and abs(square - math.sqrt(2 / math.pi)) \
                < 1e-3, (mean, square, flat.numel())
        del got, wants


EDGE_A = (0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1)
EDGE_B = (0, 1, 2 ** 30 - 1, 2 ** 30, 2 ** 30 + 1, 2 ** 31, 3 * 2 ** 30,
          2 ** 32 - 1)


def test_noise_box_muller_matches_plain_on_chosen_words(cuda):
    """The kernel's float32 Box-Muller and transform alone against the
    float64 plain version: on every pair of the edge words (u1 = 1 and
    near it, the log1p switch at a = 2^31, the quadrant boundaries of b,
    where the plain version's tiny values must keep their signs) and on
    10^6 random pairs; 1e-5 with the same signs."""
    a = torch.tensor(EDGE_A, dtype=torch.int64, device=cuda)
    b = torch.tensor(EDGE_B, dtype=torch.int64, device=cuda)
    edge = torch.stack(torch.meshgrid(a, b, indexing="ij"), -1).reshape(-1)
    g = torch.Generator(device=cuda).manual_seed(8)
    rand = torch.randint(0, 2 ** 32, (2 * 10 ** 6,), generator=g,
                         device=cuda)
    before = launches()
    for words in (edge, rand):
        got = box_muller(words)
        want = scaled_box_muller_plain(words)
        assert got.dtype == torch.float32 and got.shape == words.shape
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
        assert torch.equal(torch.sign(got), torch.sign(want))
    assert launches() == before  # not a launch of the main path


def _check_pong_deltas(cuda, steps=6):
    """K10 on real 1,024-env pong deltas: two engines with one seed step the
    same random actions, one densely and one with step_delta; each delta
    (its counts as delta_offsets) goes through K10 against the card's frame
    stack (advanced by KC with every step's observations and resets, as
    the engine's mirror of it is) and equals its plain version and the
    dense engine's observations, bit for bit, unpadded and padded to its
    bucket. At least one step takes the delta form."""
    from rainbow_tpu_torch.envs.engine import BatchedEnv

    n = 1024
    dense, delta = (BatchedEnv("pong", n, 5) for _ in range(2))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    try:
        first = dense.reset_all()
        assert np.array_equal(first, delta.reset_all())
        stack = pp.init_framestack(n, 4, first, cuda)
        rng = np.random.default_rng(6)
        deltas = 0
        for step in range(steps):
            acts = rng.integers(0, dense.action_space, n)
            obs, resets, _, _, kinds = dense.step(acts)
            counts, dpos, dval, _, _, _, kinds_d = delta.step_delta(acts)
            assert np.array_equal(kinds, kinds_d), step
            want = dev(obs)
            if counts is None:  # the engine's dense fallback
                assert np.array_equal(dpos, obs), step
            else:
                deltas += 1
                offsets = dev(ttrain.delta_offsets(counts))
                for pos, val in ((dpos, dval), ttrain.pack_delta(dpos, dval)):
                    args = (offsets, dev(pos), dev(val))
                    got = apply_delta(stack, *args)
                    assert torch.equal(
                        got, ttrain._apply_delta_plain(stack, *args)), step
                    assert torch.equal(got, want), step
            packed, ridx = pack_resets(resets, kinds)
            append_framestack(stack, want, dev(packed), dev(ridx),
                              dev(kinds))
    finally:
        dense.close()
        delta.close()
    assert deltas > 0


@pytest.mark.parametrize("h,padded", [(4, False), (4, True), (3, True),
                                      ("pong", None)])
def test_delta_kernel_matches_plain(cuda, h, padded):
    """K10 against its plain version on random deltas over nine envs (one
    unchanged, one whose whole plane changed), unpadded and padded, at
    H = 4 and 3, one launch a call; and on real pong deltas
    (_check_pong_deltas)."""
    if h == "pong":
        _check_pong_deltas(cuda)
        return
    rng = np.random.default_rng(h)
    n = 9
    stack = torch.from_numpy(rng.integers(0, 256, (n, 84, 84, h), np.uint8))
    counts = np.array([0 if e == 2 else rng.integers(1, 300)
                       for e in range(n)], np.int32)
    counts[5] = 84 * 84  # a whole plane
    pos = np.concatenate([np.sort(rng.choice(84 * 84, c, replace=False))
                          for c in counts]).astype(np.uint16)
    val = rng.integers(0, 256, pos.shape[0]).astype(np.uint8)
    if padded:
        pos, val = ttrain.pack_delta(pos, val)
    args = [torch.from_numpy(x) for x in (ttrain.delta_offsets(counts), pos,
                                          val)]
    want = ttrain._apply_delta_plain(stack, *args)
    reset_launches()
    got = apply_delta(stack.to(cuda), *(a.to(cuda) for a in args))
    assert launches()["apply_delta"] == 1
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [1, 1024])
def test_delta_kernel_at_one_and_1024_envs(cuda, n):
    """K10 at one env and at the canonical 1024, with an env (at N = 1 the
    only one) whose whole plane changed and, at 1024, unchanged envs and
    positions past the plane (dropped), padded to a bucket: the plain
    version's bits, in one kernel node."""
    rng = np.random.default_rng(n)
    stack = torch.from_numpy(rng.integers(0, 256, (n, 84, 84, 4), np.uint8))
    counts = rng.integers(0, 80, n).astype(np.int32)
    counts[n // 2] = 84 * 84
    pos = np.concatenate([
        np.arange(84 * 84) if e == n // 2
        else np.sort(rng.choice(84 * 84 + 50, c, replace=False))
        for e, c in enumerate(counts)]).astype(np.uint16)
    val = rng.integers(0, 256, pos.shape[0]).astype(np.uint8)
    pos, val = ttrain.pack_delta(pos, val)
    args = [torch.from_numpy(x) for x in (ttrain.delta_offsets(counts), pos,
                                          val)]
    want = ttrain._apply_delta_plain(stack, *args)
    dev_stack = stack.to(cuda)
    dev_args = [a.to(cuda) for a in args]
    got = apply_delta(dev_stack, *dev_args)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, ttrain._apply_delta_plain(dev_stack, *dev_args))
    assert _graph_kernels(lambda: apply_delta(dev_stack, *dev_args)) \
        == (1, 1)


# (the configuration's changes to the canonical preset, the ring's envs,
# columns and write head): a small net, and the canonical net at its batch.
SEQUENTIAL_NETS = {
    "small": (dict(num_envs=4, memory_capacity=128, hidden_size=32,
                   batch_size=4), (4, 32, 9)),
    "canonical": ({}, (8, 64, 30))}


@pytest.mark.parametrize("net", list(SEQUENTIAL_NETS))
def test_sequential_learn_step_on_card_matches_cpu(cuda, net):
    """Two sequential learner updates (learn_step: K5, K6, K2, KA, KB, K4,
    K9, K7) on the card and on the CPU from the same state; the noise comes
    from the agents' noise streams, drawn by K2 on the card and by its
    plain version on the CPU. Every param moved by more than lr/100."""
    kw, ring = SEQUENTIAL_NETS[net]
    cfg = rainbow_tpu_torch.canonical(sequential_per=True, **kw)
    n_act = 6  # _card_ring's actions are below 6
    base = _card_ring("cpu", *ring, True)
    out = {}
    for dev in ("cuda", "cpu"):
        agent = ag.init_agent(cfg, n_act, 0, "cpu")
        agent = ag.AgentState(
            params={k: v.to(dev) for k, v in agent.params.items()},
            target_params={k: v.to(dev) for k, v in
                           agent.target_params.items()},
            opt_state=ag.init_adam({k: v.to(dev) for k, v in
                                    agent.params.items()}, cfg),
            generator=torch.Generator(device=dev), noise=NoiseStream(4))
        rep = rp.ReplayState(**{f.name: getattr(base, f.name).to(dev).clone()
                                for f in dataclasses.fields(base)})
        u = torch.Generator().manual_seed(6)
        reset_launches()
        losses = [float(ag.learn_step(agent, rep, cfg, n_act, 0.5,
                                      {"u": torch.rand(cfg.batch_size,
                                                       generator=u)
                                       .to(dev)}))
                  for _ in range(2)]
        out[dev] = (losses, agent, rep, launches())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    tol = 6.25e-5 / 100
    params0 = ag.init_agent(cfg, n_act, 0, "cpu").params
    for k, v in out["cpu"][1].params.items():
        torch.testing.assert_close(out["cuda"][1].params[k].cpu(), v,
                                   atol=tol, rtol=0)
        assert float((v - params0[k]).abs().max()) > tol, k
    torch.testing.assert_close(out["cuda"][2].priorities.cpu(),
                               out["cpu"][2].priorities, atol=1e-4, rtol=1e-4)
    assert out["cuda"][1].noise == out["cpu"][1].noise
    assert out["cuda"][3] == dict(
        dict.fromkeys(LAUNCHES, 0), scaled_noise=2, noisy_linear_fwd=24,
        dueling_head=4, noisy_linear_bwd=8, c51_target=2, head_loss=2,
        clip_adam=2, stratified_sample=2, gather_window=2,
        write_priorities=2)


def _round_inputs(cfg, n_act, dev, seq, n_shards=1):
    """Agents, replay shards and draws of a learner round, the same on any
    device: the _card_ring of 4 envs per shard, init_agent's params, draws
    from a CPU generator and the CPU noise stream."""
    nl, bs = 2, cfg.batch_size // n_shards
    gen, ns = torch.Generator().manual_seed(8), NoiseStream(8)
    lead = (nl,) if seq else (nl * bs,)
    draws, reps = [], []
    for s in range(n_shards):
        d = {"u": torch.rand((nl, bs) if seq else (nl * bs,), generator=gen),
             "target": draw_noise(cfg, n_act, ns, lead, "cpu"),
             "online": draw_noise(cfg, n_act, ns, (nl,), "cpu")}
        if s:  # the online noise is the same on every shard
            d["online"] = draws[0]["online"]
        draws.append({"u": d["u"].to(dev), **{
            k: {n: (x.to(dev), y.to(dev)) for n, (x, y) in d[k].items()}
            for k in ("target", "online")}})
        base = _card_ring("cpu", 4, 32, 9, True, seed=9 + s)
        reps.append(rp.ReplayState(**{f.name: getattr(base, f.name).to(dev)
                                      for f in dataclasses.fields(base)}))
    agent = ag.init_agent(cfg, n_act, 0, "cpu")
    agent = ag.AgentState(
        params={k: v.to(dev) for k, v in agent.params.items()},
        target_params={k: v.to(dev) for k, v in agent.target_params.items()},
        opt_state=ag.init_adam({k: v.to(dev) for k, v in
                                agent.params.items()}, cfg),
        generator=torch.Generator(device=dev))
    return agent, reps, draws


@pytest.fixture
def deterministic_cudnn(cuda):
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda
    torch.backends.cudnn.deterministic = before


@pytest.mark.parametrize("seq", [False, True], ids=["batched", "sequential"])
def test_one_rank_nccl_round_matches_learner_round(deterministic_cudnn, seq):
    """The distributed round over a world-size-1 NCCL group (its all-reduces
    run) against train.learner_round on the same inputs and draws: the
    loss, params, Adam state, priorities and max_priority bit for bit, and
    the same kernel launches."""
    import socket
    import torch.distributed as dist
    cfg = rainbow_tpu_torch.canonical(num_envs=4, memory_capacity=128,
                                      hidden_size=32, batch_size=4,
                                      sequential_per=seq)
    n_act, nl = 6, 2
    out = []
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        for distributed in (False, True):
            agent, (rep,), (d,) = _round_inputs(cfg, n_act, "cuda", seq)
            reset_launches()
            if distributed:
                loss = pl.distributed_round([agent], [rep], cfg, n_act, nl,
                                            0.5, pl.Shards(["cuda"], cfg),
                                            [d])
            else:
                loss = ttrain.learner_round(agent, rep, cfg, n_act, nl, 0.5,
                                            d)
            torch.cuda.synchronize()
            out.append((loss, agent, rep, launches()))
    finally:
        dist.destroy_process_group()
    (l0, a0, r0, c0), (l1, a1, r1, c1) = out
    assert torch.equal(l0, l1) and c0 == c1
    for tree in ("params", "target_params"):
        for k, v in getattr(a0, tree).items():
            assert torch.equal(getattr(a1, tree)[k], v), (tree, k)
    for k in a0.params:
        assert torch.equal(a1.opt_state.mu[k], a0.opt_state.mu[k]), k
        assert torch.equal(a1.opt_state.nu[k], a0.opt_state.nu[k]), k
    assert torch.equal(a1.opt_state.count, a0.opt_state.count)
    assert torch.equal(r1.priorities, r0.priorities)
    assert torch.equal(r1.max_priority, r0.max_priority)


def test_two_shards_on_one_card_match_the_cpu(deterministic_cudnn):
    """Two shards on one card and one stream (their K5 levels and tickets
    share kernels.device_buffer's buffers, in stream order) against the
    same two shards on the CPU: params to lr/100, priorities to 1e-4,
    replicas bit-identical; a second run on the card gives the same bits."""
    cfg = rainbow_tpu_torch.canonical(num_envs=8, memory_capacity=256,
                                      hidden_size=32, batch_size=8)
    n_act, out = 6, {}
    for run, dev in (("card", "cuda"), ("again", "cuda"), ("cpu", "cpu")):
        agent, reps, draws = _round_inputs(cfg, n_act, dev, False, 2)
        agents = pl.replicate(agent, [dev, dev])
        loss = pl.distributed_round(agents, reps, cfg, n_act, 2, 0.5,
                                    pl.Shards([dev, dev], cfg), draws)
        out[run] = (loss.cpu(), agents, [r.priorities.cpu() for r in reps])
    for k, v in out["card"][1][0].params.items():
        assert torch.equal(out["card"][1][1].params[k], v), k
        assert torch.equal(out["again"][1][0].params[k], v), k
        torch.testing.assert_close(v.cpu(), out["cpu"][1][0].params[k],
                                   atol=6.25e-5 / 100, rtol=0)
    for got, again, want in zip(out["card"][2], out["again"][2],
                                out["cpu"][2]):
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert out["card"][0] == pytest.approx(float(out["cpu"][0]), rel=1e-4)


def test_data_parallel_trainer_on_one_card(cuda, tmp_path):
    """The sharded Trainer on the card: data_parallel with two shards on
    cuda:0, the pipelined actor staging each shard's rows through pinned
    memory on its stream; the replicas stay bit-identical and every
    iteration launches one append per shard."""
    cfg = rainbow_tpu_torch.data_efficient(
        num_envs=8, memory_capacity=8 * 128, batch_size=8, total_steps=256,
        learn_start=64, replay_frequency=4, target_update=128,
        evaluation_interval=10 ** 9, architecture="data-efficient",
        hidden_size=32, multi_step=3, env_backend="fake",
        results_dir=str(tmp_path), run_id="dp", max_episode_length=400,
        data_parallel=True, pipeline_actor=True, pipeline_depth=2)
    tr = ttrain.Trainer(cfg, devices=["cuda:0", "cuda:0"])
    reset_launches()
    tr.run()
    counts = launches()
    assert tr.T == 256 and tr.agent.step > 0
    a, b = tr.agents
    for k, v in a.params.items():
        assert torch.equal(b.params[k], v), k
    # (the validation states' appends come on top)
    assert counts["append_framestack"] >= 2 * tr.T // cfg.num_envs
    assert counts["clip_adam"] == 2 * tr.agent.step


# Kernels that convert between NCHW and NHWC around a convolution (cuDNN's
# own transposes) or pool NCHW activations.
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw", "max_pool_forward_nchw",
                  "max_pool_backward_nchw")


# The float32 Nature net, and each benchmark cell whose torso is the IMPALA
# ResNet (it runs channels-last), at the learner's batch of 1,024 rows.
LAYOUT_CASES = card_cases.layout_cases(CELLS)


def _update_on_card(cfg, cuda, traced=False):
    """One learner update of ``cfg``'s net at its batch as the round runs
    it (the target forward, the double-Q selection, the loss forward and
    backward, clip + Adam), on frame-major batches as K6 gathers them,
    after a warm-up update: it launches each kernel as often as one update
    needs (KA's backward on its large path where bwd_plan says so); each of
    the three torso forwards takes an NCHW input; the gradients that reach
    K9 are float32, contiguous and OIHW; KA's fc_h forward on the torso's
    features and K9 on the gradients agree with their plain versions (KA
    within the dtype's tolerances, K9 after one step from zero moments to
    1e-7 with a float32 mu and lr·2^-7 with a bf16 one). With ``traced``,
    the update runs under torch.profiler; returns the names of the device
    kernels it launched, or None."""
    from torch.profiler import ProfilerActivity, profile

    from rainbow_tpu_torch.kernels.replay import window_fields
    from rainbow_tpu_torch.models.dqn import NOISY_LAYERS, _noisy_dims
    n_act, b = 6, cfg.batch_size
    h, n = cfg.history_length, cfg.multi_step
    g = torch.Generator(device=cuda).manual_seed(3)
    win = torch.randint(0, 256, (1, b, h + n, 84 * 84), generator=g,
                        device=cuda, dtype=torch.uint8)
    fields = window_fields(win, h, n, {})
    batch = {"states": rp.states_to_float(fields["states"][0]),
             "next_states": rp.states_to_float(fields["next_states"][0]),
             "actions": torch.randint(0, n_act, (b,), generator=g,
                                      device=cuda, dtype=torch.int32),
             "returns": torch.randn((b,), generator=g, device=cuda),
             "nonterminals": torch.ones((b,), device=cuda),
             "weights": torch.rand((b,), generator=g, device=cuda) + 0.5}
    agent = ag.init_agent(cfg, n_act, 0, cuda)
    eps = draw_noise(cfg, n_act, NoiseStream(4), device=cuda)

    def update():
        with torch.no_grad():
            pns = dqn.forward_head(agent.target_params, cfg, n_act,
                                   batch["next_states"], dist="probs",
                                   noise_eps=eps).dist
        grads, _ = ag.compute_update_pretarget(agent, cfg, n_act, batch,
                                               pns, eps)
        ag.apply_grads(agent, cfg, grads)
        return grads

    update()
    torch.cuda.synchronize()
    dqn.reset_torso_inputs()
    reset_launches()
    names = None
    if traced:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grads = update()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    else:
        grads = update()
    dt = getattr(torch, cfg.compute_dtype)
    dims = _noisy_dims(cfg, n_act)
    large = sum(bwd_plan(b, *dims[k], 1, dt).path == "large"
                for k in NOISY_LAYERS)
    assert launches() == dict(
        dict.fromkeys(LAUNCHES, 0), noisy_linear_fwd=12, dueling_head=2,
        c51_target=1, head_loss=1, noisy_linear_bwd=4,
        noisy_linear_bwd_large=large, clip_adam=1)
    assert {k: v for k, v in dqn.torso_inputs().items() if v} == {
        f"{cfg.architecture}.nchw": 3}
    dqn.reset_torso_inputs()
    shapes = dqn.param_shapes(cfg, n_act)
    assert list(grads) == list(shapes)
    for k, shape in shapes.items():
        assert grads[k].dtype == torch.float32, k
        assert grads[k].is_contiguous() and tuple(grads[k].shape) == shape, k
    with torch.no_grad():
        feat = dqn.torso(agent.params, cfg, batch["states"].to(dt))
    dqn.reset_torso_inputs()
    fc_h = dqn.layer(agent.params, "fc_h_v")
    tol = (1e-4, 1e-4) if dt == torch.float32 else (6e-2, 3e-2)
    torch.testing.assert_close(
        noisy_linear_fwd(fc_h, feat, eps["fc_h_v"], True).float(),
        noisy_linear_plain(fc_h, feat, eps["fc_h_v"], True).float(),
        atol=tol[0], rtol=tol[1])
    keys = list(shapes)
    params = {k: v.clone() for k, v in agent.params.items()}
    kernel = ag.AgentState(params=params, target_params=params,
                           opt_state=ag.init_adam(params, cfg),
                           generator=torch.Generator(device=cuda))
    plain = {k: v.clone() for k, v in params.items()}
    opt = ag.init_adam(plain, cfg)
    ag.apply_grads_plain([plain[k] for k in keys], [grads[k] for k in keys],
                         [opt.mu[k] for k in keys], [opt.nu[k] for k in keys],
                         opt.count, cfg.learning_rate, ag.ADAM_B1,
                         ag.ADAM_B2, cfg.adam_eps, cfg.norm_clip)
    ag.apply_grads(kernel, cfg, grads)
    p_tol = (1e-7 if cfg.adam_mu_dtype == "float32"
             else cfg.learning_rate * 2 ** -7)
    for k in keys:
        torch.testing.assert_close(kernel.params[k], plain[k], atol=p_tol,
                                   rtol=0, msg=k)
    return names


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_learner_update_launches_no_layout_conversion(cuda, case):
    """One learner update at the configuration's batch under
    torch.profiler (_update_on_card, with its checks): no kernel converts
    between NCHW and NHWC or pools NCHW. Each of the three torso forwards
    takes an NCHW input: the IMPALA net makes it channels-last and runs
    NHWC throughout, the float32 Nature net runs as it did, NCHW."""
    names = _update_on_card(LAYOUT_CASES[case], cuda, traced=True)
    assert any("noisy_linear" in n for n in names), names
    assert [n for n in names if any(k in n for k in LAYOUT_KERNELS)] == []
