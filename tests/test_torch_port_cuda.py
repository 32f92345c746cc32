"""The port's kernels on the card against their plain versions, at small
and ragged shapes. These need an NVIDIA GPU with nvcc and Triton; without a
card every test here skips. On the card, from the repository root
(--noconftest: tests/conftest.py sets up JAX, which the port does not need):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances as in chip_smoke.py: float32 sums in other orders agree to 1e-4;
bf16 differs by a few bf16 ulps of O(1) values; the head combines in the
streams' dtype on both sides and its float32 softmax agrees to 1e-5;
integer work is bit-exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import rainbow_tpu_torch
from rainbow_tpu_torch.envs.fake import FakeAtariEnv
from rainbow_tpu_torch.kernels import launches, reset_launches
from rainbow_tpu_torch.kernels.append_framestack import append_framestack
from rainbow_tpu_torch.kernels.dueling_head import dueling_head_fwd
from rainbow_tpu_torch.kernels.noisy_linear import noisy_linear_fwd
from rainbow_tpu_torch.models.dqn import draw_noise, init_dqn_params
from rainbow_tpu_torch.models.noisy import (init_noisy_params,
                                            noisy_linear_plain, scale_noise)
from rainbow_tpu_torch.ops import preprocess as pp
from rainbow_tpu_torch.ops.c51 import support_vector
from rainbow_tpu_torch.ops.head import dueling_head_plain
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch.train import actor_step_packed, pack_resets, stage_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["mu", "shared", "row"])
def test_noisy_linear_kernel_matches_plain(cuda, mode, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    b, n_in, n_out = 37, 301, 70  # ragged against every tile edge
    prm = init_noisy_params(g, n_in, n_out, 0.5)
    x = (torch.rand((b, n_in), generator=g, device=cuda) * 2).to(dt)
    lead = (b,) if mode == "row" else ()
    eps = None if mode == "mu" else (scale_noise(g, lead + (n_in,)),
                                     scale_noise(g, lead + (n_out,)))
    tol = (1e-4, 1e-4) if dt == torch.float32 else (6e-2, 3e-2)
    for relu in (False, True):
        got = noisy_linear_fwd(prm, x, eps, relu)
        want = noisy_linear_plain(prm, x, eps, relu)
        assert got.dtype == dt
        torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dist", [None, "probs", "log"])
def test_dueling_head_kernel_matches_plain(cuda, dist, dtype):
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    z = support_vector(-10.0, 10.0, 51, cuda)
    for n_act in (3, 18):
        v = (torch.randn((29, 51), generator=g, device=cuda) * 2).to(dt)
        a = (torch.randn((29, n_act * 51), generator=g, device=cuda)
             * 2).to(dt)
        got = dueling_head_fwd(v, a, z, n_act, dist)
        want = dueling_head_plain(v, a, z, n_act, dist)
        torch.testing.assert_close(got[1], want.q, atol=1e-5, rtol=0)
        torch.testing.assert_close(got[3], want.max_q, atol=1e-5, rtol=0)
        if dist:
            torch.testing.assert_close(got[0], want.dist, atol=1e-5, rtol=0)
        top2 = want.q.topk(2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > 1e-5
        assert torch.equal(got[2][clear], want.action[clear])


def _same(a, b):
    return all(torch.equal(getattr(a, f.name).cpu(), getattr(b, f.name).cpu())
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("history", [4, 3])
def test_append_framestack_kernel_matches_plain(cuda, history):
    rng = np.random.default_rng(2)
    n, c = 40, 3
    u8 = lambda *s: torch.from_numpy(rng.integers(0, 256, s, np.uint8))
    stack0 = u8(n, 84, 84, history)
    states = {dev: (stack0.to(dev, copy=True), rp.init_replay(n, c, 84, dev))
              for dev in ("cuda", "cpu")}
    for step in range(4):  # wraps the three-column ring
        kinds = rng.integers(0, 3, n).astype(np.uint8)
        packed, ridx = pack_resets(rng.integers(0, 256, (n, 84, 84),
                                                np.uint8), kinds)
        inputs = [u8(n, 84, 84), torch.from_numpy(packed),
                  torch.from_numpy(ridx), torch.from_numpy(kinds)]
        extra = [torch.from_numpy(rng.integers(0, 6, n)),
                 torch.from_numpy(rng.normal(size=n).astype(np.float32) * 3),
                 torch.from_numpy(kinds > 0)]
        for dev, fn in (("cuda", append_framestack),
                        ("cpu", pp.append_framestack_plain)):
            stack, rep = states[dev]
            fn(stack, *(t.to(dev) for t in inputs), rep,
               *(t.to(dev) for t in extra), 1.0)
        assert torch.equal(states["cuda"][0].cpu(), states["cpu"][0])
        assert _same(states["cuda"][1], states["cpu"][1])


def test_actor_steps_on_card_match_cpu(cuda):
    """Five actor iterations on the fake env through the kernels and through
    the plain versions, with the same injected noise."""
    cfg = rainbow_tpu_torch.data_efficient(hidden_size=32)
    n, a_space = 8, 4
    params = init_dqn_params(cfg, a_space, torch.Generator().manual_seed(0),
                             "cpu")
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
            noise = draw_noise(cfg, a_space, torch.Generator().manual_seed(i),
                               (n,))
            noise = {k: (x.to(dev), y.to(dev)) for k, (x, y) in noise.items()}
            out = env.step(np.zeros(n, np.int64) + i % a_space)
            acts = actor_step_packed(p, None, cfg, a_space, stack, rep, acts,
                                     *stage_step(out, dev), noise_eps=noise)
            history.append(acts.cpu())
        runs[dev] = (stack.cpu(), rep, history, launches())
    assert torch.equal(runs["cuda"][0], runs["cpu"][0])
    assert _same(runs["cuda"][1], runs["cpu"][1])
    assert runs["cuda"][3] == {"noisy_linear_fwd": 20, "dueling_head": 5,
                               "append_framestack": 5}
    assert runs["cpu"][3] == {"noisy_linear_fwd": 0, "dueling_head": 0,
                              "append_framestack": 0}
    agree = sum(torch.equal(x, y) for x, y in zip(runs["cuda"][2],
                                                   runs["cpu"][2]))
    assert agree >= 4  # a near-tie may flip one step's argmax
