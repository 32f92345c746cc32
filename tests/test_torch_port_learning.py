"""Learning smoke of the port's Trainer on the fake env, on the CPU: the
bar of tests/test_train_smoke.py::test_learning_on_fake_env_improves_reward
(a greedy probe scores 1.5x the random policy's 12.5 per episode).

The fake env rewards action == t % A, which the net can read from the
frame's stripe. CPU torch is deterministic for a given thread count but
not across thread counts (the sums' order moves the score), so the test
pins 4 threads and the fixed seed passes or fails the same way on every
run. The seed starts the Trainer from the JAX package's initial params
for it (agent.init_agent), from which the outcome mostly follows.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.envs.fake import FakeAtariEnv
from rainbow_tpu_torch.ops.preprocess import (append_framestack,
                                              init_framestack,
                                              to_network_input)
from rainbow_tpu_torch.train import Trainer, stage_step

from test_train_smoke import tiny_cfg


@pytest.fixture(autouse=True)
def _four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _greedy_probe_score(tr, cfg):
    """Greedy-policy score per episode on a fresh eval env (as the JAX
    test's probe)."""
    env = FakeAtariEnv(8, seed=99, episode_len=50, training=False)
    stack = init_framestack(8, cfg.history_length, env.reset_all(), "cpu")
    total = 0.0
    for _ in range(50):
        acts = ag.act(tr.agent.params, cfg, env.action_space,
                      to_network_input(stack))
        out = env.step(acts.numpy())
        total += out[2].sum()
        obs, packed, ridx, _, _, kinds = stage_step(out, "cpu")
        append_framestack(stack, obs, packed, ridx, kinds)
    return total / 8


def test_learning_on_fake_env_improves_reward(tmp_path):
    # The JAX test's config (which tries up to three seeds) with one seed
    # and a learning rate of 3e-3 instead of 1e-3.
    cfg = RainbowConfig(**dataclasses.asdict(tiny_cfg(
        tmp_path, total_steps=6000, learn_start=200,
        evaluation_interval=10 ** 9, num_envs=8, memory_capacity=8 * 512,
        learning_rate=3e-3, multi_step=3, batch_size=32, seed=1,
        run_id="learn")))
    tr = Trainer(cfg, device="cpu")
    tr.run()
    score = _greedy_probe_score(tr, cfg)
    random_score = 50 / 4  # episode_len / action_space
    assert score > 1.5 * random_score, score
    assert np.isfinite(float(tr._last_loss))
