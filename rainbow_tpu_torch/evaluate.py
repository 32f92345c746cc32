"""Evaluation protocol (rainbow_tpu/evaluate.py; reference test.py:13-58),
batched: the episodes run as parallel eval-mode envs (one episode each,
ε-greedy, true game-over terminals only) and the validation-Q probe is a
few batched forwards. Metric semantics are the reference's.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.ops.preprocess import (append_framestack,
                                              init_framestack,
                                              to_network_input)
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch.train import stage_step


def _params_device(params: dict) -> torch.device:
    return next(iter(params.values())).device


def build_validation_states(cfg: RainbowConfig, make_env,
                            device="cuda") -> torch.Tensor:
    """Random-policy validation states for the held-out Q probe
    (reference main.py:126-136): a small replay filled with uniform-random
    actions, returned as an (evaluation_size, 84, 84, H) float batch."""
    dev = resolve_device(device)
    n_envs = min(10, cfg.evaluation_size)
    steps = -(-cfg.evaluation_size // n_envs)  # ceil
    env = make_env(num_envs=n_envs, training=True)
    rng = np.random.default_rng(cfg.seed + 977)
    rep = rp.init_replay(n_envs, steps, cfg.frame_size, dev)
    stack = init_framestack(n_envs, cfg.history_length, env.reset_all(), dev)
    zeros = torch.zeros(n_envs, dtype=torch.float32, device=dev)
    for _ in range(steps):
        actions = rng.integers(0, env.action_space, n_envs)
        obs, packed, ridx, _, dones, kinds = stage_step(
            env.step(actions), dev)
        append_framestack(stack, obs, packed, ridx, kinds, rep,
                          torch.from_numpy(actions).to(dev), zeros, dones)
    env.close()
    return rp.all_states(rep, cfg.history_length)[:cfg.evaluation_size]


def run_episodes(cfg: RainbowConfig, params: dict, action_space: int,
                 make_env, generator: torch.Generator, num_episodes: int,
                 render_dir: str = "") -> List[float]:
    """One episode per parallel eval env; returns per-episode total rewards
    (unclipped, reference test.py:21-34). Eval mode: life losses do not
    terminate (reference env.py:70 gate off). ``generator`` draws the
    ε-greedy exploration on the params' device. render_dir: if set, saves
    env 0's frames as images there (headless analogue of reference
    env.py:90-92)."""
    dev = _params_device(params)
    env = make_env(num_envs=num_episodes, training=False)
    stack = init_framestack(num_episodes, cfg.history_length,
                            env.reset_all(), dev)
    totals = np.zeros(num_episodes)
    finished = np.zeros(num_episodes, bool)
    # Safety cap: max_episode_length raw frames / 4 per agent step, plus slack.
    max_iters = (cfg.max_episode_length or 10 ** 9) // 4 + 100
    it = 0

    def next_actions():
        return ag.act_e_greedy(params, cfg, action_space,
                               to_network_input(stack), generator,
                               cfg.eval_epsilon).cpu().numpy()

    actions = next_actions()
    can_deactivate = hasattr(env, "set_active")
    while not finished.all() and it < max_iters:
        out = env.step(actions)
        rewards, dones = out[2], out[3].astype(bool)
        totals += np.where(finished, 0.0, rewards)
        newly_done = dones & ~finished
        finished |= dones
        if can_deactivate and newly_done.any() and not finished.all():
            # Stop simulating finished episodes: the slowest episode should
            # not keep N-1 dead envs burning engine CPU (their rewards are
            # masked above anyway; frames freeze, which the net never sees
            # scored).
            env.set_active(~finished)
        obs, packed, ridx, _, _, kinds = stage_step(out, dev)
        append_framestack(stack, obs, packed, ridx, kinds)
        actions = next_actions()
        if render_dir and not finished[0]:
            _save_frame(render_dir, it, out[0][0])
        it += 1
    env.close()
    return totals.tolist()


def _save_frame(render_dir: str, step: int, frame) -> None:
    os.makedirs(render_dir, exist_ok=True)
    path = f"{render_dir}/frame_{step:06d}"
    try:
        import cv2
        cv2.imwrite(path + ".png", np.asarray(frame))
    except ImportError:  # binary PGM needs no image library
        with open(path + ".pgm", "wb") as f:
            f.write(b"P5\n84 84\n255\n" + np.asarray(frame).tobytes())


def validation_q(cfg: RainbowConfig, params: dict, action_space: int,
                 val_states: torch.Tensor, chunk: int = 250) -> List[float]:
    """Avg max-Q over the held-out states (reference test.py:38-39), in
    batched chunks."""
    qs: List[float] = []
    for i in range(0, val_states.shape[0], chunk):
        q = ag.evaluate_q(params, cfg, action_space, val_states[i:i + chunk])
        qs.extend(q.cpu().tolist())
    return qs


def evaluate(cfg: RainbowConfig, params: dict, action_space: int, make_env,
             val_states: torch.Tensor, generator: torch.Generator
             ) -> Tuple[float, float, List[float], List[float]]:
    render_dir = ""
    if cfg.render:
        render_dir = os.path.join(cfg.results_dir, cfg.run_id, "render")
    rewards = run_episodes(cfg, params, action_space, make_env, generator,
                           cfg.evaluation_episodes, render_dir=render_dir)
    qs = validation_q(cfg, params, action_space, val_states)
    return (float(np.mean(rewards)), float(np.mean(qs)), rewards, qs)
