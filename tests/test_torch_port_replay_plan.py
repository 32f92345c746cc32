"""The designs of the replay append + frame-stack kernel (KC,
kernels/append_framestack.py), of the stratified sampler (K5) and of the
priority write-back (K7, kernels/replay.py), held on the CPU where no card
is:

- K5's tree plan (the stored levels every fifth height, their offsets in
  the scratch, the first step's levels, the launches) and a torch
  rendering of its five-level descent, which gives stratified_sample_plain's
  bits and the JAX package's _stratified_find's draws;
- KC's launch plan, the precondition of its binary search (pack_resets'
  rows sorted ascending, distinct, padded with N, for every bucket), and a
  numpy rendering of its vector path (a pixel's history as one 32-bit word,
  the shift-and-insert per reset kind) against append_framestack_plain and
  the JAX package's update_framestack;
- K7's grid (write_blocks: one thread a draw, every draw once) and a torch
  rendering of its threads (batch-order element q as draw j, the next
  draw's leaf, the last draw of a run writing) and of its max (int words,
  NaN as 0x7fc00000, an atomicMax a block) against update_priorities_plain,
  NaN and -0.0 losses and an old NaN of either sign included.

Everything here is exact: integer work, and float sums in the tree's own
pairing on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu.ops import preprocess as jpp
from rainbow_tpu.replay import prioritized as jrp

from rainbow_tpu_torch.kernels import append_framestack as kc
from rainbow_tpu_torch.kernels import replay as k_replay
from rainbow_tpu_torch.kernels.replay import STEP, tree_plan
from rainbow_tpu_torch.ops import preprocess as tpp
from rainbow_tpu_torch.replay import prioritized as trp
from rainbow_tpu_torch.train import _RESET_BUCKETS, pack_resets


# ------------------------------------------------------------------ K5 ----

@pytest.mark.parametrize("n", [1, 2, 3, 16, 17, 32, 33, 100, 1024, 1025,
                               62464, 999424, 1 << 20, (1 << 20) + 1,
                               k_replay.MAX_LEAVES])
def test_tree_plan_stores_every_fifth_level(n):
    plan = tree_plan(n)
    assert plan.leaves == 1 << plan.depth and plan.leaves >= n
    assert plan.leaves // 2 < n or n == 1
    assert plan.heights == tuple(h for h in range(1, plan.depth)
                                 if h % STEP == 0)
    sizes = [plan.leaves >> h for h in plan.heights]
    assert plan.offsets == tuple(np.cumsum([0] + sizes[:-1]).tolist()) \
        or not sizes
    assert plan.scratch == sum(sizes) <= k_replay.SCRATCH
    assert plan.scratch <= plan.leaves // 31  # about L/32, never the leaves
    # The first step descends 1 to 5 levels (0 for one leaf) to the highest
    # stored level, or to the leaves; every other step five.
    assert plan.first_step + STEP * len(plan.heights) == plan.depth
    assert 1 <= plan.first_step <= STEP or plan.depth == 0
    assert plan.launches == (2 if plan.depth > STEP else 1)
    assert len(plan.heights) <= 4  # csrc/replay.cu's MAX_STORED


def _render_k5(flat, u, plan):
    """K5's design in torch. The stored levels: each node of height h the
    sum of its 32 descendants at h - 5, by five pairwise sums (a warp's
    xor shuffles), in one scratch at plan.offsets. The descent: from the
    root a step of plan.first_step levels, then steps of five down to the
    leaves; each step loads the node's 2^k children (from the scratch, or at
    the bottom the masked leaves), rebuilds the levels between by pairwise
    sums and descends them with `value > left`. The first step's sum is the
    total."""
    n = flat.shape[0]
    leaves = torch.zeros(plan.leaves)
    leaves[:n] = flat
    scratch = torch.zeros(plan.scratch)
    cur = leaves
    for h, off in zip(plan.heights, plan.offsets):
        for _ in range(STEP):
            cur = cur.view(-1, 2).sum(1)
        scratch[off:off + cur.numel()] = cur

    def level(h):
        if h == 0:
            return leaves
        off = plan.offsets[plan.heights.index(h)]
        return scratch[off:off + (plan.leaves >> h)]

    b = u.shape[0]
    node = torch.zeros(b, dtype=torch.int64)
    height, total, v = plan.depth, None, None
    for k in [plan.first_step] + [STEP] * len(plan.heights):
        height -= k
        width = 1 << k
        kids = level(height)[node[:, None] * width + torch.arange(width)]
        lv = [kids]
        for _ in range(k):
            lv.append(lv[-1].view(b, -1, 2).sum(2))
        if total is None:
            total = lv[k][0, 0]
            seg = total / torch.full((), float(b))
            v = (torch.arange(b, dtype=torch.float32) + u) * seg
        base = torch.zeros(b, dtype=torch.int64)
        for t in range(k - 1, -1, -1):
            left = lv[t].gather(1, (base >> t)[:, None])[:, 0]
            right = v > left
            base = base + right.long() * (1 << t)
            v = v - torch.where(right, left, torch.zeros_like(left))
        node = node * width + base
    assert height == 0
    idx = node.clamp(max=n - 1)
    return idx, leaves[idx], total


def _priority_ring(e, c, index, prio, seed=0):
    """A full ring of priorities alone (one-byte frames) on the CPU:
    exponential priorities with a tenth zeros, ones, or zeros."""
    rng = np.random.default_rng(seed)
    rep = trp.init_replay(e, c, 1, "cpu")
    if prio == "exp":
        pr = rng.exponential(size=(e, c)).astype(np.float32)
        pr[rng.random((e, c)) < 0.1] = 0.0
        rep.priorities.copy_(torch.from_numpy(pr))
    elif prio == "ones":
        rep.priorities.fill_(1.0)
    rep.index.fill_(index)
    rep.full.fill_(True)
    return rep


K5_RINGS = {
    # name: (E, C, index, history, n_step, B, priorities); the depth is
    # log2 of the padded leaf count. ties: ones and u = 0, so that each
    # value j·total/B is a left sum exactly (B = the 576 unmasked leaves,
    # or half of them).
    "depth_0_empty": (1, 1, 0, 4, 3, 4, "exp"),
    "depth_1": (1, 2, 0, 1, 0, 5, "exp"),
    "depth_4": (2, 8, 3, 4, 1, 32, "exp"),
    "depth_5": (3, 9, 4, 2, 1, 16, "exp"),
    "depth_7": (5, 20, 7, 4, 3, 32, "exp"),
    "depth_10": (10, 90, 50, 4, 3, 256, "exp"),
    "depth_10_b1": (10, 90, 50, 4, 3, 1, "exp"),
    "depth_20": (1024, 976, 500, 4, 3, 8192, "exp"),
    "ties": (64, 16, 8, 4, 3, 576, "ones"),
    "ties_seg_2": (64, 16, 8, 4, 3, 288, "ones"),
    "empty": (4, 32, 9, 4, 3, 8, "zeros"),
}


@pytest.mark.parametrize("case", list(K5_RINGS))
def test_five_level_descent_gives_the_plain_bits(case):
    e, c, index, hist, n_step, b, prio = K5_RINGS[case]
    rep = _priority_ring(e, c, index, prio)
    u = (torch.zeros(b) if prio == "ones"
         else torch.from_numpy(np.random.default_rng(1).random(b)
                               .astype(np.float32)))
    plan = tree_plan(e * c)
    want = trp.stratified_sample_plain(rep, u, hist, n_step)
    got = _render_k5(trp._masked_flat_priorities(rep, hist, n_step), u, plan)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w), case
    if case.startswith("depth_"):
        assert plan.depth == int(case.split("_")[1])
    if prio == "ones":
        assert float(want[2]) == e * (c - hist - n_step)
    if prio != "exp" or case == "depth_0_empty":
        assert float(want[2]) == (0.0 if prio != "ones"
                                  else e * (c - hist - n_step))


@pytest.mark.parametrize("case", ["depth_7", "depth_10", "ties"])
def test_five_level_descent_matches_jax(case):
    """The rendering draws JAX's leaves: the same masked priorities, and
    u drawn from the key as jrp._stratified_find draws it."""
    e, c, index, hist, n_step, b, prio = K5_RINGS[case]
    rep = _priority_ring(e, c, index, prio)
    flat = trp._masked_flat_priorities(rep, hist, n_step)
    key = jax.random.key(7)
    j_idx, j_p, j_total = jrp._stratified_find(jnp.asarray(flat.numpy()),
                                               key, b)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (b,),
                                                     jnp.float32)))
    idx, p, total = _render_k5(flat, u, tree_plan(e * c))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j_p))
    assert float(total) == float(j_total)


# ------------------------------------------------------------------ KC ----

@pytest.mark.parametrize("n,p,h", [(1024, 84 * 84, 4), (10, 84 * 84, 4),
                                   (1, 84 * 84, 4), (40, 84 * 84, 3),
                                   (3, 42 * 42, 4), (5, 7, 2), (2, 6, 4)])
def test_kc_launch_plan_covers_every_pixel_once(n, p, h):
    plan = kc.launch_plan(n, p, h)
    assert plan.vector == (h == 4 and p % 4 == 0)
    if plan.vector:  # quads of 4 pixels, 4 a thread
        assert plan.items * 4 == n * p
        per_block = kc.THREADS * kc.QUADS
    else:  # 16-pixel chunks of each env, one a thread
        assert (plan.items // n - 1) * kc.CHUNK < p <= plan.items // n \
            * kc.CHUNK
        per_block = kc.THREADS
    assert (plan.blocks - 1) * per_block < plan.items \
        <= plan.blocks * per_block
    if (n, p) == (1024, 84 * 84):
        assert (plan.items, plan.blocks) == (1806336, 3528)
    if (n, p) == (10, 84 * 84):
        assert plan.blocks == 35  # the evaluator's step spreads over 35 SMs


@pytest.mark.parametrize("n", [1, 10, 40, 1024])
def test_pack_resets_gives_kc_sorted_rows_padded_with_n(n):
    """KC finds an env's reset row by binary search, so pack_resets must
    give the reset envs sorted ascending and distinct, then N, in a bucket
    of _RESET_BUCKETS capped at N: checked for a reset count at every
    bucket's edges, with the lower bound of each env as the kernel takes
    it."""
    rng = np.random.default_rng(n)
    counts = {0, n} | {c for b in _RESET_BUCKETS for c in (b - 1, b, b + 1)
                       if 0 <= c <= n}
    for k in sorted(counts):
        kinds = np.zeros(n, np.uint8)
        kinds[rng.choice(n, size=k, replace=False)] = rng.integers(1, 3, k)
        resets = rng.integers(0, 256, (n, 3, 3), np.uint8)
        packed, idx = pack_resets(resets, kinds)
        assert idx.dtype == np.int32 and packed.shape[0] == idx.shape[0]
        assert idx.shape[0] == next(min(b, n) for b in _RESET_BUCKETS
                                    if b >= k)
        assert np.all(np.diff(idx[:k]) > 0) and np.all(idx[k:] == n)
        np.testing.assert_array_equal(idx[:k], np.flatnonzero(kinds))
        rows = np.searchsorted(idx, np.arange(n))
        found = (rows < idx.shape[0]) & (
            idx[np.minimum(rows, idx.shape[0] - 1)] == np.arange(n)
            if idx.shape[0] else False)
        np.testing.assert_array_equal(found, kinds != 0)
        np.testing.assert_array_equal(packed[rows[found]], resets[found])


def _render_kc(stack, obs, packed, ridx, kinds):
    """KC's vector path in numpy: a pixel's four frames as one little-endian
    32-bit word, its newest frame the top byte, each reset kind a
    shift-and-insert, the reset row by lower bound in ridx. Returns the
    new stack and the newest frames it replaced."""
    n, f = obs.shape[:2]
    w = stack.reshape(n, f * f, 4).view("<u4")[..., 0]
    o = obs.reshape(n, f * f).astype(np.uint32)
    rows = np.searchsorted(ridx, np.arange(n))
    k = ridx.shape[0]
    hit = (rows < k) & (ridx[np.minimum(rows, k - 1)] == np.arange(n)
                        if k else False)
    r = np.zeros((n, f * f), np.uint32)
    r[hit] = packed[rows[hit]].reshape(-1, f * f)
    kind = kinds.astype(np.int64)[:, None]
    new = np.where(kind == 0, (w >> 8) | (o << 24),
                   np.where(kind == 1, (w >> 16) | (o << 16) | (r << 24),
                            r << 24)).astype("<u4")
    newest = (w >> 24).astype(np.uint8).reshape(n, f, f)
    return new.view(np.uint8).reshape(n, f, f, 4), newest


@pytest.mark.parametrize("k_mode", ["none", "bucket", "dense"])
def test_kc_word_rendering_matches_plain_and_jax(k_mode):
    rng = np.random.default_rng(11)
    n, c = 40, 3
    stack = rng.integers(0, 256, (n, 84, 84, 4), np.uint8)
    obs = rng.integers(0, 256, (n, 84, 84), np.uint8)
    resets = rng.integers(0, 256, (n, 84, 84), np.uint8)
    kinds = rng.integers(0, 3, n).astype(np.uint8)
    if k_mode == "none":
        kinds[:] = 0
    if k_mode == "dense":
        packed, ridx = resets, np.arange(n, dtype=np.int32)
    else:
        packed, ridx = pack_resets(resets, kinds)
    new, newest = _render_kc(stack, obs, packed, ridx, kinds)

    st = torch.from_numpy(stack.copy())
    rep = trp.init_replay(n, c, 84, "cpu")
    tpp.append_framestack_plain(
        st, torch.from_numpy(obs), torch.from_numpy(packed),
        torch.from_numpy(ridx), torch.from_numpy(kinds), rep,
        torch.zeros(n, dtype=torch.int64), torch.zeros(n),
        torch.from_numpy(kinds > 0))
    np.testing.assert_array_equal(new, st.numpy())
    np.testing.assert_array_equal(newest.reshape(n, -1),
                                  rep.frames[:, 0].numpy())
    dense = np.where((kinds != 0)[:, None, None], resets, 0)
    want = jpp.update_framestack(*map(jnp.asarray, (stack, obs, dense,
                                                     kinds)))
    np.testing.assert_array_equal(new, np.asarray(want))


# ------------------------------------------------------------------ K7 ----

NAN_WORD = 0x7fc00000  # csrc/replay.cu: the max's word of any NaN


def test_k7_write_blocks_cover_every_draw_once():
    for b in range(1, 8194):
        blocks = k_replay.write_blocks(b)
        assert (blocks - 1) * k_replay.WRITE_THREADS < b \
            <= blocks * k_replay.WRITE_THREADS, b
    assert k_replay.write_blocks(8192) == 32  # the round: 32 of 132 SMs
    assert k_replay.write_blocks(32) == 1     # the sequential update


def _max_word(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), NAN_WORD, x.view(torch.int32))


def _render_k7(rep, idxs, losses, omega):
    """K7's design in torch: thread q of write_blocks(B) blocks takes
    element q of the (nb, bs) inputs as draw j = (q % bs)·nb + q // bs,
    reads the next draw's leaf at element ((j+1) % nb)·bs + (j+1) // nb and
    writes its priority only where that leaf differs (the last draw of a
    run); the max is the int max of the words of each block, combined
    block by block with max_priority's word by atomicMax (NAN_WORD from a
    block that read an old NaN). Returns (priorities, max_priority) after
    the launch."""
    nb, bs = idxs.shape
    b = nb * bs
    flat, p = idxs.reshape(-1), losses.reshape(-1) ** omega
    q = torch.arange(b)
    jn = (q % bs) * nb + q // bs + 1
    nxt = torch.where(jn < b, flat[((jn % nb) * bs + jn // nb) % b], -1)
    prio = rep.priorities.clone().view(-1)
    writes = nxt != flat
    assert flat[writes].unique().numel() == int(writes.sum())  # no races
    prio[flat[writes]] = p[writes]
    old_nan = bool(torch.isnan(rep.max_priority))
    word = int(rep.max_priority.view(torch.int32))  # the old max's bits
    words = _max_word(p)
    for blk in range(k_replay.write_blocks(b)):  # an atomicMax a block
        w = int(words[blk * k_replay.WRITE_THREADS:
                      (blk + 1) * k_replay.WRITE_THREADS].max())
        word = max(word, NAN_WORD if old_nan else w)
    return prio.view(rep.priorities.shape), torch.tensor(
        word, dtype=torch.int32).view(torch.float32)


def _same_bits(a, b):
    """Equal bits, or NaN in both."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


# (nb, bs, runs of one leaf in draw order as [start, stop), special): the
# round and the sequential update, ragged layouts, runs inside a block of
# 256 threads and across a block edge (batch order puts draws j and j + 1
# at elements bs apart, so draws 5..12 of the round straddle the edge
# between batches 7 and 8), the whole round on one leaf, NaN and -0.0.
K7_CASES = {
    "b1": (1, 1, (), None),
    "b31_run": (1, 31, ((3, 9),), None),
    "b33": (3, 11, ((0, 4),), None),
    "b255": (15, 17, ((100, 120),), None),
    "b256": (8, 32, ((0, 256),), None),
    "b257_across_edge": (1, 257, ((250, 257),), None),
    "round": (256, 32, ((1, 4), (5, 13), (250, 261)), None),
    "round_hot_leaf": (256, 32, ((0, 8192),), None),
    "round_nan_loss": (256, 32, ((5, 13),), "nan"),
    "b32_nan_loss_in_a_run": (1, 32, ((3, 9),), "nan"),
    "b32_negative_zero": (1, 32, (), "-0"),
    "round_old_nan": (256, 32, ((5, 13),), "old_nan"),
    "round_old_negative_nan": (256, 32, (), "old_negative_nan"),
}


@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_rendering_matches_plain(case):
    nb, bs, runs, special = K7_CASES[case]
    b = nb * bs
    rng = np.random.default_rng(len(case))
    rep = _priority_ring(64, 976, 500, "exp", seed=3)
    rep.max_priority.fill_(float(rep.priorities.max()))
    if special == "old_nan":
        rep.max_priority.fill_(float("nan"))
    if special == "old_negative_nan":  # what x86 makes of 0·inf
        rep.max_priority.view(torch.int32).fill_(-0x400000)
    draw = np.sort(rng.integers(0, 64 * 976, b))
    for a, z in runs:  # still nondecreasing: draw[a] <= draw[z]
        draw[a:z] = draw[a]
    loss_draw = rng.uniform(0.0, 5.0, b).astype(np.float32)
    if special == "nan":
        loss_draw[6] = np.nan  # inside the run, not its last draw
    if special == "-0":
        loss_draw[7] = -0.0
    j = np.arange(b)
    idxs = torch.from_numpy(draw.reshape(bs, nb).T.copy())
    losses = torch.from_numpy(loss_draw.reshape(bs, nb).T.copy())
    assert torch.equal(idxs[j % nb, j // nb], torch.from_numpy(draw))
    prio, mx = _render_k7(rep, idxs, losses, 0.5)

    plain = dataclasses.replace(rep, priorities=rep.priorities.clone(),
                                max_priority=rep.max_priority.clone())
    trp.update_priorities_plain(plain, idxs, losses, 0.5)
    assert _same_bits(mx, plain.max_priority)
    assert torch.isnan(mx) == (special in ("nan", "old_nan",
                                           "old_negative_nan"))
    want = rep.priorities.clone().view(-1)
    last = np.append(draw[1:] != draw[:-1], True)
    p_draw = torch.from_numpy(loss_draw) ** 0.5
    want[torch.from_numpy(draw[last])] = p_draw[torch.from_numpy(last)]
    assert _same_bits(prio.view(-1), want)
    once = torch.bincount(torch.from_numpy(draw), minlength=64 * 976) <= 1
    assert _same_bits(prio.view(-1)[once], plain.priorities.view(-1)[once])
    if special == "-0":  # torch.pow keeps the sign: the leaf holds -0.0
        assert int(prio.view(-1)[draw[7]].view(torch.int32)) == -2 ** 31


# ------------------------------------------------------------------ K6 ----

# (num_batches, batch_size, window): the data-efficient round (window 24),
# the canonical one and the throughput preset's (window 7), one sequential
# batch, the widest window.
GATHER_PLANS = [(16, 32, 24), (256, 32, 7), (32, 256, 7), (1, 32, 7),
                (3, 5, 64)]


@pytest.mark.parametrize("nb, bs, w", GATHER_PLANS)
def test_gather_plan_covers_every_row_and_frame_once(nb, bs, w):
    """K6's one launch: a field block a batch whose warps take rows v,
    v + 8, ...; then one copy warp a window frame, 8 a block. Copy warp f
    takes frame f % w of output row q = f // w, which is draw (q % bs)·nb +
    q // bs: gather_window_plain's batch order, every (draw, frame) once."""
    warps = k_replay.GATHER_WARPS
    plan = k_replay.gather_plan(nb, bs, w)
    assert plan.field_blocks == nb
    assert plan.copy_warps == nb * bs * w
    assert plan.copy_blocks == -(-plan.copy_warps // warps)
    assert plan.blocks == nb + plan.copy_blocks
    rows = [(k, r) for k in range(nb) for v in range(warps)
            for r in range(v, bs, warps)]
    assert sorted(rows) == [(k, r) for k in range(nb) for r in range(bs)]
    assert plan.rows_a_warp == len(range(0, bs, warps))
    f = torch.arange(plan.copy_blocks * warps)
    f = f[f < plan.copy_warps]
    q, t = f // w, f % w
    j = (q % bs) * nb + q // bs
    assert torch.equal(torch.sort(j * w + t).values,
                       torch.arange(nb * bs * w))
    order = torch.arange(nb * bs).view(bs, nb).T.reshape(-1)
    assert torch.equal(j[t == 0], order)


def _render_k6(rep, idx, nb, bs, history, n_step):
    """A rendering of K6's warps on the CPU: each copy warp's window frame
    (its row's draw, the ballot of `timesteps == 0` over the window, the
    blanking mask, the frame or zeros) and each field warp's action and
    nonterminal."""
    e_, c = rep.priorities.shape
    w = history + n_step
    plan = k_replay.gather_plan(nb, bs, w)
    ts = rep.timesteps

    def blank_of(flat):
        e, i = divmod(int(flat), c)
        firsts = sum(1 << t for t in range(w)
                     if int(ts[e, (i + t - history + 1) % c]) == 0)
        blank = 0
        for t in range(history - 2, -1, -1):
            if ((blank | firsts) >> (t + 1)) & 1:
                blank |= 1 << t
        for t in range(history, w):
            if ((blank >> (t - 1)) | (firsts >> t)) & 1:
                blank |= 1 << t
        return e, i, blank

    window = torch.empty((plan.copy_warps, rep.frames.shape[2]),
                         dtype=torch.uint8)
    for f in range(plan.copy_warps):
        q, t = divmod(f, w)
        e, i, blank = blank_of(idx[(q % bs) * nb + q // bs])
        window[f] = 0 if (blank >> t) & 1 else \
            rep.frames[e, (i + t - history + 1) % c]
    actions = torch.empty((nb, bs), dtype=torch.int32)
    nonterminals = torch.empty((nb, bs))
    for k in range(nb):
        for r in range(bs):
            e, i, blank = blank_of(idx[r * nb + k])
            actions[k, r] = rep.actions[e, i]
            nonterminals[k, r] = float(bool(rep.nonterminal[e, (i + n_step)
                                                            % c])
                                       and not (blank >> (w - 1)) & 1)
    return window.view(nb, bs, w, -1), actions, nonterminals


@pytest.mark.parametrize("nb, bs, n_step", [(16, 32, 20), (4, 64, 3),
                                            (2, 256, 3), (1, 8, 60)])
def test_k6_rendering_matches_plain(nb, bs, n_step):
    """The copy warps' frames, blanked where an episode starts or ends
    inside the window, and the field warps' actions and nonterminals are
    gather_window_plain's, exactly (frames of 4 x 4 bytes)."""
    rng = np.random.default_rng(7)
    e, c, history = 8, 96, 4
    rep = trp.init_replay(e, c, 4, "cpu")
    rep.frames.copy_(torch.from_numpy(rng.integers(0, 256, rep.frames.shape,
                                                   np.uint8)))
    rep.actions.copy_(torch.from_numpy(rng.integers(0, 6, (e, c), np.int32)))
    rep.timesteps.copy_(torch.from_numpy(rng.integers(0, 6, (e, c),
                                                      np.int32)))
    rep.nonterminal.copy_(torch.from_numpy(rng.random((e, c)) > 0.1))
    rep.priorities.copy_(torch.from_numpy(rng.exponential(size=(e, c))
                                          .astype(np.float32)))
    rep.index.fill_(40)
    rep.full.fill_(True)
    u = torch.from_numpy(rng.random(nb * bs).astype(np.float32))
    idx, p, total = trp.stratified_sample_plain(rep, u, history, n_step)
    want = trp.gather_window_plain(rep, idx, p, total, 0.6, nb, bs, history,
                                   n_step, 0.99)
    window, actions, nonterminals = _render_k6(rep, idx, nb, bs, history,
                                               n_step)
    plain_window = want["states"]._base.reshape(window.shape)
    assert torch.equal(window, plain_window)
    assert bool((window == 0).all(-1).any())  # some frames are blanked
    assert torch.equal(actions, want["actions"])
    assert torch.equal(nonterminals, want["nonterminals"])
    # Episodes last 6 steps on average: past n = 32 every row is blanked
    # at its end.
    assert 0 < float(nonterminals.mean()) < 1 or n_step > 32
