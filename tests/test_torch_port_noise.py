"""The port's noise draws (K2's plain version, models/noisy.py) on the CPU:
Philox4x32-10 against Random123's known answers, the moments of the scaled
noise, the stream's offsets, draw_noise's shapes against the JAX
package's, the noise stream through a checkpoint, the kernel's buffer
layout (kernels/noise.py::noise_layout), and the plain Box–Muller on the
words where the kernel's float32 reductions have their edges.

The draws cannot match JAX's bits (threefry), so JAX is compared on shapes
and dtypes only; the values are held to Random123's vectors (exact) and to
the distribution's moments.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import rainbow_tpu
from rainbow_tpu.models import dqn as jdqn

import rainbow_tpu_torch
from rainbow_tpu_torch.kernels import noise as k2
from rainbow_tpu_torch.models import dqn as tdqn
from rainbow_tpu_torch.models import noisy as tnoisy
from rainbow_tpu_torch.train import Trainer

from test_train_smoke import tiny_cfg

A = 6


@pytest.mark.parametrize("ctr,key,want", [
    # Random123's kat_vectors for philox4x32_10 (Salmon et al., SC'11).
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    got = tnoisy.philox4x32_10(torch.tensor([ctr], dtype=torch.int64), key)
    assert tuple(got[0].tolist()) == want


def test_scaled_noise_moments():
    """sign(n)·√|n| of a standard normal: mean 0, E[ε²] = E|n| = √(2/π).
    Over 10⁵ draws the sampling error is about 0.003 and 0.002; each is
    held to 0.01."""
    eps = tnoisy.scale_noise(tnoisy.NoiseStream(11), (100_000,), "cpu")
    assert eps.dtype == torch.float32 and torch.isfinite(eps).all()
    eps = eps.double()
    assert abs(float(eps.mean())) < 0.01
    assert abs(float((eps * eps).mean()) - math.sqrt(2 / math.pi)) < 0.01


def test_draws_take_disjoint_offsets():
    """A draw advances the stream by the words it used (four per Philox
    counter, a counter per four elements of each tensor); one draw of two
    tensors equals two draws of one, and successive draws differ."""
    shapes = [(3, 7), (5,), (2, 4)]
    s = tnoisy.NoiseStream(3, offset=8)
    first = tnoisy.draw_scaled_noise(s, shapes, "cpu")
    assert s.offset == 8 + tnoisy.noise_words(shapes) == 8 + 4 * (6 + 2 + 2)
    second = tnoisy.draw_scaled_noise(s, shapes, "cpu")
    assert all(not torch.equal(a, b) for a, b in zip(first, second))
    one = tnoisy.NoiseStream(3, offset=8)
    parts = [tnoisy.scale_noise(one, shp, "cpu") for shp in shapes]
    assert all(torch.equal(a, b) for a, b in zip(first, parts))
    assert one.offset == 8 + tnoisy.noise_words(shapes)
    # The plain version is a function of (seed, offset, shapes) alone.
    again = tnoisy.philox_noise_plain(3, 8, shapes)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    other_seed = tnoisy.philox_noise_plain(4, 8, shapes)
    assert not torch.equal(first[0], other_seed[0])


@pytest.mark.parametrize("lead", [(), (3,)])
def test_draw_noise_shapes_match_jax(lead):
    jcfg = rainbow_tpu.data_efficient(hidden_size=32)
    tcfg = rainbow_tpu_torch.data_efficient(hidden_size=32)
    want = jdqn.draw_noise(jcfg, A, jax.random.key(0), lead=lead)
    got = tdqn.draw_noise(tcfg, A, tnoisy.NoiseStream(0), lead, "cpu")
    assert list(got) == list(want)
    for k, (a, b) in got.items():
        for g, w in ((a, want[k][0]), (b, want[k][1])):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            assert str(w.dtype) == "float32"
    # Two sets in one draw are draw_noise twice, in order.
    s = tnoisy.NoiseStream(9)
    two = tdqn.draw_noise_sets(tcfg, A, s, [lead, ()], "cpu")
    s2 = tnoisy.NoiseStream(9)
    ones = (tdqn.draw_noise(tcfg, A, s2, lead, "cpu"),
            tdqn.draw_noise(tcfg, A, s2, device="cpu"))
    for got_set, want_set in zip(two, ones):
        assert all(torch.equal(got_set[k][i], want_set[k][i])
                   for k in got_set for i in (0, 1))
    assert s.offset == s2.offset


def test_draws_default_to_the_card():
    """Without a device, every noise draw goes to the card (one launch of
    the noise kernel); without a card it raises and leaves the stream where
    it was. The CPU's plain version runs only when asked for."""
    cfg = rainbow_tpu_torch.data_efficient(hidden_size=32)
    calls = (lambda s: tnoisy.scale_noise(s, (5,)),
             lambda s: tnoisy.draw_scaled_noise(s, [(5,), (3,)])[0],
             lambda s: tdqn.draw_noise(cfg, A, s, (2,))["fc_z_a"][0],
             lambda s: tdqn.draw_noise_sets(cfg, A, s, [()])[0]["fc_h_v"][1])
    for call in calls:
        s = tnoisy.NoiseStream(1, offset=4)
        if torch.cuda.is_available():
            assert call(s).device.type == "cuda"
            assert s.offset > 4
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call(s)
            assert s.offset == 4


def test_noise_stream_survives_a_checkpoint(tmp_path):
    cfg = rainbow_tpu_torch.RainbowConfig(
        **dataclasses.asdict(tiny_cfg(tmp_path)))
    tr = Trainer(cfg, device="cpu")
    tr._draw_act_noise()
    tr._draw_act_noise()
    stream = dataclasses.replace(tr.agent.noise)
    assert stream.offset > 0
    tr.save_checkpoint()
    want = tr._draw_act_noise()
    back = Trainer(cfg, device="cpu")
    assert back.agent.noise.offset == 0
    back.restore_checkpoint(f"{tr.results_dir}/checkpoint.npz")
    assert back.agent.noise == stream
    got = back._draw_act_noise()
    assert all(torch.equal(got[k][i], want[k][i]) for k in got for i in (0, 1))


@pytest.mark.parametrize("shapes", [
    [(3,), (), (5, 7), (1,), (2, 3, 3)],       # none a multiple of 4
    [(), (301,), (), (70,), (4, 51), (0,)],    # () leads, an empty tensor
    [(8192, 3136), (8192, 512), (256, 51), (256, 306)],
], ids=["ragged", "scalars", "round"])
def test_noise_layout_packs_a_draw_into_one_aligned_buffer(shapes):
    """Each tensor starts at a multiple of 4 floats (16 bytes), at 4 × the
    Philox counters of the tensors before it; the tensors do not overlap;
    the buffer is the draw's noise_words long. The plain draw laid out that
    way is the stream's counters in order: tensor k is the slice of the
    draw-wide Box–Muller output at its offset, its padding the spare values
    of its last counter."""
    offsets, total = k2.noise_layout(tuple(shapes))
    assert total == tnoisy.noise_words(shapes)
    assert len(offsets) == len(shapes) and offsets[0] == 0
    ends = [o + math.prod(s) for o, s in zip(offsets, shapes)]
    for k, o in enumerate(offsets):
        assert o % 4 == 0
        assert o == 4 * sum(-(-math.prod(s) // 4) for s in shapes[:k])
        assert ends[k] <= (offsets[k + 1] if k + 1 < len(shapes) else total)
    if total > 10 ** 6:
        return
    seed, offset = 2 ** 40 + 3, 4 * 77
    c = torch.arange(offset // 4, offset // 4 + total // 4)
    zero = torch.zeros_like(c)
    words = tnoisy.philox4x32_10(
        torch.stack((c & 0xFFFFFFFF, c >> 32, zero, zero), dim=-1),
        (seed & 0xFFFFFFFF, seed >> 32))
    buf = tnoisy.scaled_box_muller_plain(words).reshape(-1)
    want = tnoisy.philox_noise_plain(seed, offset, shapes)
    for o, s, w in zip(offsets, shapes, want):
        assert torch.equal(buf[o:o + math.prod(s)].view(s), w)


EDGE_A = (0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1)
EDGE_B = (0, 1, 2 ** 30 - 1, 2 ** 30, 2 ** 30 + 1, 2 ** 31, 3 * 2 ** 30,
          2 ** 32 - 1)


def test_plain_box_muller_on_edge_words_is_the_float64_formula():
    """scaled_box_muller_plain on the words at the edges of the kernel's
    float32 reductions (u1 = 1 and near it, the log1p switch at a = 2^31,
    the quadrant boundaries of b) is the stream's float64 formula, written
    out here in numpy, rounded once to float32. At b = 2^30, 2^31 and
    3·2^30 the float64 cos or sin of fl(qπ/2) is a tiny value of definite
    sign, which the kernel must reproduce."""
    a, b = (x.ravel() for x in np.meshgrid(np.array(EDGE_A, np.int64),
                                           np.array(EDGE_B, np.int64),
                                           indexing="ij"))
    r = np.sqrt(-2.0 * np.log((a.astype(np.float64) + 1.0) * 2.0 ** -32))
    t = 6.283185307179586 * (b.astype(np.float64) * 2.0 ** -32)
    z = np.stack((r * np.cos(t), r * np.sin(t)), axis=-1).reshape(-1)
    want = (np.sign(z) * np.sqrt(np.abs(z))).astype(np.float32)
    words = torch.from_numpy(np.stack((a, b), axis=-1).reshape(-1))
    got = tnoisy.scaled_box_muller_plain(words)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    # The boundary values: positive at b = 2^30 (cos) and 2^31 (sin),
    # negative at 3·2^30 (cos), for every a below 2^32 − 1 (where r = 0).
    at = {(int(x), int(y)): (float(got[2 * i]), float(got[2 * i + 1]))
          for i, (x, y) in enumerate(zip(a, b))}
    for x in EDGE_A[:-1]:
        assert 0 < at[x, 2 ** 30][0] < 1e-7
        assert 0 < at[x, 2 ** 31][1] < 1e-7
        assert -1e-7 < at[x, 3 * 2 ** 30][0] < 0
        assert at[x, 0][1] == 0.0
    assert all(v == (0.0, 0.0) for (x, _), v in at.items() if x == 2 ** 32 - 1)


def test_plain_noise_values_are_pinned():
    """philox_noise_plain's values, bit for bit, as the stream defines them
    (the CPU tests that learn depend on the exact draws)."""
    got = tnoisy.philox_noise_plain(2 ** 40 + 5, 4 * 12345,
                                    [(2, 3), (5,), ()])
    want = [[0xbe3f837a, 0xbf8836f6, 0xbeca3ab6, 0xbf93c29d, 0xbec6576f,
             0x3fcf5bee],
            [0x3f61de86, 0x3f72fd41, 0x3f8e493c, 0x3f5b6a9f, 0xbf3a2bd1],
            [0x3e7d7eeb]]
    for g, w in zip(got, want):
        assert g.reshape(-1).numpy().view(np.uint32).tolist() == w
