"""FakeAtari — a scripted, deterministic batched env with the engine API.

The pure-python fixture env from the test plan (SURVEY.md §4c): known
rewards, a lives mechanic, and fixed episode lengths, so the full training
loop, life-loss logic, auto-reset contract and eval protocol are testable
without the native engine (and fast under CI). Implements the exact
BatchedEnv interface/contract of envs/engine.py.

Game: at agent-step t of an episode, action ``t % action_space`` earns
reward 1, others 0. A life is lost every ``life_every`` agent steps
(training mode → pseudo-terminal, reset_kind 1); the episode truly ends
after ``episode_len`` agent steps (reset_kind 2). Frames carry two signals:
a background value (33 + env_id * 7 + step * 11) % 251 capped at 120 so
tests can verify exact frame plumbing, and a bright stripe whose row
position encodes ``t % action_space`` — a spatially learnable cue so the
conv net can solve the task quickly in learning smoke tests.
"""
from __future__ import annotations


import numpy as np

FRAME = 84


def frame_value(env_id: int, step: int) -> int:
    """Background plumbing code, capped below the stripe brightness."""
    return min((33 + env_id * 7 + step * 11) % 251, 120)


class FakeAtariEnv:
    def __init__(self, num_envs: int, seed: int = 0, action_space: int = 4,
                 episode_len: int = 20, life_every: int = 0,
                 training: bool = True):
        self.num_envs = num_envs
        self.action_space = action_space
        self.episode_len = episode_len
        self.life_every = life_every
        self.training = training
        self._step = np.zeros(num_envs, np.int64)  # within-episode agent step
        # Double-buffered outputs, flipped per step — same contract as the
        # native engine: the previous step's arrays stay valid while the
        # overlapped pipeline runs the next step on a worker thread.
        self._bufs = tuple((np.empty((num_envs, FRAME, FRAME), np.uint8),
                            np.zeros((num_envs, FRAME, FRAME), np.uint8))
                           for _ in range(2))
        self._flip = 0

    def set_training(self, training: bool) -> None:
        self.training = training

    def _frame(self, e: int, step: int) -> np.ndarray:
        f = np.full((FRAME, FRAME), frame_value(e, step), np.uint8)
        # Bright stripe: row block encodes the rewarded action t % A.
        band = FRAME // self.action_space
        y = (step % self.action_space) * band
        f[y:y + band // 2, :] = 255
        return f

    def reset_all(self) -> np.ndarray:
        self._step[:] = 0
        return np.stack([self._frame(e, 0) for e in range(self.num_envs)])

    def step(self, actions: np.ndarray):
        n = self.num_envs
        obs, reset_frames = self._bufs[self._flip]
        self._flip ^= 1
        rewards = np.zeros(n, np.float32)
        dones = np.zeros(n, np.uint8)
        kinds = np.zeros(n, np.uint8)
        for e in range(n):
            t = self._step[e]
            rewards[e] = 1.0 if actions[e] == t % self.action_space else 0.0
            nxt = t + 1
            obs[e] = self._frame(e, nxt)
            if nxt >= self.episode_len:  # true game over
                dones[e], kinds[e] = 1, 2
                self._step[e] = 0
                reset_frames[e] = self._frame(e, 0)
            elif (self.training and self.life_every
                  and nxt % self.life_every == 0):  # life loss
                dones[e], kinds[e] = 1, 1
                self._step[e] = nxt + 1  # the single no-op consumed a step
                reset_frames[e] = self._frame(e, nxt + 1)
            else:
                self._step[e] = nxt
        return obs, reset_frames, rewards, dones, kinds

    def close(self) -> None:
        pass
