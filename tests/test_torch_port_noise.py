"""The port's noise draws (K2's plain version, models/noisy.py) on the CPU:
Philox4x32-10 against Random123's known answers, the moments of the scaled
noise, the stream's offsets, draw_noise's shapes against the JAX
package's, and the noise stream through a checkpoint.

The draws cannot match JAX's bits (threefry), so JAX is compared on shapes
and dtypes only; the values are held to Random123's vectors (exact) and to
the distribution's moments.
"""
import dataclasses
import math

import jax
import pytest
import torch

import rainbow_tpu
from rainbow_tpu.models import dqn as jdqn

import rainbow_tpu_torch
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
