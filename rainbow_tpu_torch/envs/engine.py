"""ctypes binding to the C++ batched environment engine (librainbow_env.so).

The native engine replaces the reference's single-ALE-instance Python wrapper
(reference env.py:9-95) with N lockstep environments behind one call per
agent step. See envs/cpp/engine.cc for the auto-reset contract. This module
also auto-builds the .so on first import if the checkout is fresh.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(__file__), "cpp")
_LIB_PATH = os.path.join(_CPP_DIR, "librainbow_env.so")

GAMES = ("pong", "breakout", "space_invaders", "freeway", "qbert", "boxing",
         "ms_pacman", "asteroids", "seaquest", "kangaroo", "crazy_climber",
         "frostbite", "demon_attack", "gopher", "alien", "amidar", "assault",
         "asterix", "bank_heist", "battle_zone", "chopper_command", "hero",
         "jamesbond", "krull", "kung_fu_master", "private_eye",
         "road_runner", "up_n_down")

# The 26 games of the Atari-100k benchmark (data-efficient Rainbow paper,
# reference README.md:72 ref [9]) — all native here; BASELINE config[4].
ATARI_100K_GAMES = tuple(g for g in GAMES
                         if g not in ("space_invaders", "asteroids"))
FRAME = 84

# Static pad sizes for sparse-delta uploads (bounds jit specialisations).
DELTA_BUCKETS = (1024, 4096, 16384, 65536, 262144, 1 << 20, 1 << 22)


def delta_bucket(k: int):
    """Smallest static delta bucket >= k, or None when k exceeds the table
    (callers must use the dense path — an exact-size shape would trigger a
    fresh jit specialisation per distinct delta size)."""
    for b in DELTA_BUCKETS:
        if b >= k:
            return b
    return None


def _load_lib() -> ctypes.CDLL:
    # Always invoke make: a no-op when the .so is current, a rebuild when
    # sources are newer (a stale prebuilt .so would silently run old game
    # dynamics and lack newer symbols). The Makefile links via tmp+mv, so
    # processes holding the old mapping are unaffected. The build is
    # serialised with an flock so simultaneously launched processes (e.g.
    # the 2-process jax.distributed path) cannot interleave compiler writes
    # into the same tmp file and produce a corrupt .so (ADVICE r4).
    try:
        with open(os.path.join(_CPP_DIR, ".build.lock"), "w") as lockf:
            import fcntl
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                subprocess.run(["make", "-C", _CPP_DIR], check=True,
                               capture_output=True)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    except (OSError, subprocess.CalledProcessError):
        if not os.path.exists(_LIB_PATH):  # no toolchain AND no binary
            raise
    lib = ctypes.CDLL(_LIB_PATH)
    lib.renv_create.restype = ctypes.c_void_p
    lib.renv_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.renv_destroy.argtypes = [ctypes.c_void_p]
    lib.renv_num_actions.argtypes = [ctypes.c_void_p]
    lib.renv_num_actions.restype = ctypes.c_int
    lib.renv_set_training.argtypes = [ctypes.c_void_p, ctypes.c_int]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.renv_set_active.argtypes = [ctypes.c_void_p, u8p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.renv_reset_all.argtypes = [ctypes.c_void_p, u8p]
    lib.renv_resize.argtypes = [u8p, u8p]
    lib.renv_pool_resize.argtypes = [u8p, u8p, u8p]
    lib.renv_step.argtypes = [ctypes.c_void_p, i32p, u8p, u8p, f32p, u8p, u8p]
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.renv_step_delta.argtypes = [ctypes.c_void_p, i32p, i32p, u16p, u8p,
                                    i64p, u8p, f32p, u8p, u8p]
    lib.renv_copy_obs.argtypes = [ctypes.c_void_p, u8p]
    lib.renv_game_probe.argtypes = [ctypes.c_char_p, ctypes.c_uint64, i32p,
                                    ctypes.c_int, u8p]
    lib.renv_game_probe.restype = ctypes.c_int
    lib.renv_oracle_run.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    f32p]
    lib.renv_oracle_run.restype = ctypes.c_int
    return lib


_lib = None


def game_probe(game: str, seed: int, actions: np.ndarray) -> np.ndarray:
    """Step a standalone game instance through a raw action sequence and
    return its 210x160 screen (test hook — bypasses episode semantics)."""
    global _lib
    if _lib is None:
        _lib = _load_lib()
    actions = np.ascontiguousarray(actions, np.int32)
    out = np.empty((210, 160), np.uint8)
    rc = _lib.renv_game_probe(game.encode(), seed, actions,
                              len(actions), out)
    if rc < 0:
        raise ValueError(f"unknown game {game!r}")
    return out


def pool_resize(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The engine's two-frame observation pooling: resize each 210x160 raw
    frame to 84x84, then elementwise max (the reference's order,
    env.py:60-67). Test/verification hook."""
    global _lib
    if _lib is None:
        _lib = _load_lib()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    assert a.shape == b.shape == (210, 160)
    out = np.empty((FRAME, FRAME), np.uint8)
    _lib.renv_pool_resize(a, b, out)
    return out


def oracle_run(game: str, seed: int = 0, episodes: int = 10,
               max_frames: int = int(108e3),
               frame_granular: bool = False) -> np.ndarray:
    """Play full episodes with the game's built-in perfect-information
    scripted policy; returns per-episode raw reward sums. Bounds what any
    learned agent can score on the native stand-in (the reference's quality
    bar compares against ALE game dynamics, reference README.md:7 — this
    pins what OUR dynamics allow). frame_granular=False applies the same
    x4 action repeat an agent plays under (reference env.py:54-58)."""
    global _lib
    if _lib is None:
        _lib = _load_lib()
    out = np.empty((episodes,), np.float32)
    rc = _lib.renv_oracle_run(game.encode(), seed, episodes, max_frames,
                              int(frame_granular), out)
    if rc == -1:
        raise ValueError(f"unknown game {game!r}")
    if rc == -2:
        raise NotImplementedError(f"game {game!r} has no oracle policy")
    return out


def resize_bilinear(frame: np.ndarray) -> np.ndarray:
    """The engine's 210x160 -> 84x84 bilinear resize (test/verification hook
    for parity with reference env.py:28 cv2.INTER_LINEAR)."""
    global _lib
    if _lib is None:
        _lib = _load_lib()
    src = np.ascontiguousarray(frame, np.uint8)
    assert src.shape == (210, 160)
    out = np.empty((FRAME, FRAME), np.uint8)
    _lib.renv_resize(src, out)
    return out


class BatchedEnv:
    """N native environments stepped in lockstep.

    step(actions) -> (obs, reset_frames, rewards, dones, reset_kinds):
    obs uint8 (N, 84, 84) is the step observation (the last two raw frames
    of the ×4 action repeat, each resized to 84×84, then max-pooled — the
    reference's order, env.py:60-67); reset_frames uint8 (N, 84, 84)
    is the post-reset frame (valid iff reset_kind > 0); both contiguous so
    no host repack precedes the device transfer.
    reset_kind: 0 = no reset, 1 = life-loss
    continuation (keep frame stack), 2 = full reset (clear frame stack).
    Rewards are raw (unclipped) sums over the action repeat, matching
    reference env.py:54-67.
    """

    def __init__(self, game: str, num_envs: int, seed: int,
                 max_episode_length: int = int(108e3), n_threads: int = 0,
                 training: bool = True):
        global _lib
        if _lib is None:
            _lib = _load_lib()
        self._lib = _lib
        self.num_envs = num_envs
        self.game = game
        self._h = self._lib.renv_create(game.encode(), num_envs, seed,
                                        max_episode_length, n_threads)
        if not self._h:
            raise ValueError(f"unknown game {game!r}; have {GAMES}")
        self.action_space = self._lib.renv_num_actions(self._h)
        self.set_training(training)
        # DOUBLE-BUFFERED output arrays (written in-place by C++), flipped
        # every step: the previous step's outputs stay valid while the next
        # engine step runs on a worker thread (the overlapped actor pipeline
        # stages the upload of step t while the engine computes t+1).
        mk = lambda: (np.empty((num_envs, FRAME, FRAME), np.uint8),
                      np.zeros((num_envs, FRAME, FRAME), np.uint8),
                      np.empty((num_envs,), np.float32),
                      np.empty((num_envs,), np.uint8),
                      np.empty((num_envs,), np.uint8))
        self._bufs = (mk(), mk())
        self._flip = 0
        self._ddbl = None  # delta-mode buffers, allocated on first use

    def set_training(self, training: bool) -> None:
        """Life-loss terminals on/off (reference env.py:80-85)."""
        self._lib.renv_set_training(self._h, int(training))

    def set_active(self, mask) -> None:
        """Per-env activity mask (None = all active). Inactive envs skip
        simulation in step(): they repeat their last frame with zero
        reward/done. The evaluator deactivates finished episodes so the
        slowest episode does not keep N-1 dead envs burning engine CPU."""
        if mask is None:
            mask = np.ones(self.num_envs, np.uint8)
        m = np.ascontiguousarray(np.asarray(mask, np.uint8))
        assert m.shape == (self.num_envs,)
        self._lib.renv_set_active(self._h, m)

    def reset_all(self) -> np.ndarray:
        """Full reset of every env; returns uint8 (N, 84, 84) initial frames."""
        out = np.empty((self.num_envs, FRAME, FRAME), np.uint8)
        self._lib.renv_reset_all(self._h, out)
        return out

    def step(self, actions: np.ndarray):
        actions = np.ascontiguousarray(actions, np.int32)
        assert actions.shape == (self.num_envs,)
        obs, resets, rewards, dones, kinds = self._bufs[self._flip]
        self._flip ^= 1
        self._lib.renv_step(self._h, actions, obs, resets, rewards, dones,
                            kinds)
        return (obs, resets, rewards, dones, kinds)

    def step_delta(self, actions: np.ndarray):
        """step() with the observations encoded as a sparse delta against the
        previous device-newest frame (the engine mirrors the device's
        frame-stack newest slot): returns (counts, pos, val, reset_frames,
        rewards, dones, reset_kinds) — counts int32 (N,) changed pixels per
        env, pos uint16 the within-env flat positions (compacted, ordered by
        (env, position)), val uint8 the new pixel values. 3 bytes/pixel on
        the wire. obs[e] = prev_newest[e] except at pos. The device rebuilds
        global indices with a segment expansion over counts and applies one
        sorted unique scatter (train._apply_delta).

        Near-dense fallback (decided HERE, synchronously, so overlapped
        pipelines never reach back into single-buffered engine staging):
        when the delta's padded bucket would cost >= the dense frame
        (3 bytes/entry) or exceeds the bucket table, returns
        (None, obs_dense, None, resets, ...) with obs_dense the full uint8
        (N, 84, 84) observations."""
        actions = np.ascontiguousarray(actions, np.int32)
        assert actions.shape == (self.num_envs,)
        if self._ddbl is None:
            n = self.num_envs * FRAME * FRAME
            self._ddbl = tuple((np.empty((self.num_envs,), np.int32),
                                np.empty((n,), np.uint16),
                                np.empty((n,), np.uint8)) for _ in range(2))
            self._dtotal = np.zeros((1,), np.int64)
        counts, dpos, dval = self._ddbl[self._flip]
        obs, resets, rewards, dones, kinds = self._bufs[self._flip]
        self._flip ^= 1
        self._lib.renv_step_delta(self._h, actions, counts, dpos, dval,
                                  self._dtotal, resets, rewards, dones,
                                  kinds)
        t = int(self._dtotal[0])
        num_cells = self.num_envs * FRAME * FRAME
        kp = delta_bucket(t)
        if kp is None or kp * 3 >= num_cells:
            self._lib.renv_copy_obs(self._h, obs)
            return (None, obs, None, resets, rewards, dones, kinds)
        return (counts, dpos[:t], dval[:t], resets, rewards, dones, kinds)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.renv_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
