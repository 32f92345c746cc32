"""The port's Trainer (rainbow_tpu_torch.train.Trainer) against the JAX
package's, on the CPU with the fake env.

Both Trainers run the same configs, sized like tests/test_train_smoke.py::
tiny_cfg, and each package's iteration (the JAX package's
``train_iter_packed``, the port's ``train_iter_sharded``), ``evaluate`` and
``Trainer.save_checkpoint`` are wrapped to record what the schedule decided
in every iteration: (num_learns, β, sync_target), each save's (T, name,
include_replay), which iterations redrew the act noise, and, for the
pipelined actor, how many iterations back the executed actions were
computed. The two packages draw different random numbers, so the learning
itself differs; the schedule must not. β is compared exactly: both compute
it in Python floats and pass it as np.float32.

Asynchronous evaluations are held at a gate until the end-of-run drain, in
both packages, so which evaluations run and which are skipped does not
depend on the speed of the host (the JAX package's own tests use sleeps).
"""
import dataclasses
import json
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from rainbow_tpu import evaluate as jev
from rainbow_tpu import train as jtrain
from rainbow_tpu.config import RainbowConfig as JaxConfig

from rainbow_tpu_torch import evaluate as tev
from rainbow_tpu_torch import train as ttrain
from rainbow_tpu_torch.config import RainbowConfig as TorchConfig

from test_train_smoke import tiny_cfg

CASES = {
    # the data-efficient tiny config: one learn step per iteration
    "tiny": dict(),
    # 2 envs, one learn step every 4 env-steps: iters_per_learn = 2, with a
    # decoupled replay-save interval
    "iters_per_learn_2": dict(num_envs=2, memory_path="memory",
                              memory_save_interval=96),
    # periodic checkpoints, and replay saves coupled to every evaluation
    "checkpoints": dict(checkpoint_interval=128, memory_path="memory",
                        memory_save_interval=0),
    # the pipelined actor (after tests/test_train_smoke.py:30, 64, 83):
    # depth 1, and depth 2 with a settle window of 1
    "pipeline_1": dict(pipeline_actor=True),
    "pipeline_2": dict(pipeline_actor=True, pipeline_depth=2,
                       settle_window=1),
    # async evaluation (after tests/test_train_smoke.py:96, 132, 339): one
    # snapshot may wait, the rest are skipped and a final one is forced; and
    # three workers whose evaluations finish out of order
    "async_coalesce": dict(async_eval=True, evaluation_interval=32,
                           total_steps=256, max_pending_evals=1),
    "async_workers": dict(async_eval=True, evaluation_interval=32,
                          total_steps=256, eval_workers=3),
}
_RUNS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these runs are chains of tiny ops, which several
    test workers sharing the cores would otherwise slow by thread
    contention; the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(monkeypatch, train_mod, ev_mod, iter_name, beta_at, prev_at,
            gate=None):
    """Wrap the package's iteration (``iter_name``: its act noise, if it
    takes one, is its last argument), evaluation and save; returns the log.
    With a ``gate`` (asynchronous evaluation), every evaluation waits for
    it, and the end-of-run drain opens it; the evaluations then finish in
    an order other than their submission's."""
    rec = {"iters": [], "saves": [], "evals": 0, "act": [], "lag": []}
    real_iter = getattr(train_mod, iter_name)
    real_eval = ev_mod.evaluate
    real_save = train_mod.Trainer.save_checkpoint
    real_drain = train_mod.Trainer._eval_async_drain
    produced = {}  # id of an iteration's actions -> (iteration, actions)

    def iteration(*args):
        num_learns, beta, sync = args[2], args[beta_at], args[beta_at + 1]
        assert isinstance(beta, np.float32)
        rec["iters"].append((num_learns, float(beta), bool(sync)))
        i = len(rec["iters"])
        rec["lag"].append(i - produced.get(id(args[prev_at]), (0,))[0])
        if train_mod is jtrain:  # the key JAX's act uses after this round
            key = args[3].noise_key
            if num_learns:
                key = jax.random.fold_in(jax.random.fold_in(key, 1), 1)
            rec["act"].append(np.asarray(jax.random.key_data(key)).copy())
        else:
            rec["act"].append({k: (a.clone(), b.clone())
                               for k, (a, b) in args[-1].items()})
        out = real_iter(*args)
        produced[id(out[0])] = (i, out[0])
        return out

    def evaluate(*args, **kw):
        rec["evals"] += 1
        n = rec["evals"]
        if gate is not None:
            assert gate.wait(timeout=600)
            time.sleep(0.3 if n % 2 else 0.0)  # odd ones finish later
        return real_eval(*args, **kw)

    def drain(self, wait=False):
        if wait and gate is not None:
            gate.set()
        return real_drain(self, wait)

    def save(self, name="checkpoint.npz", include_replay=None):
        rec["saves"].append((self.T, name, include_replay))
        return real_save(self, name, include_replay)

    monkeypatch.setattr(train_mod, iter_name, iteration)
    monkeypatch.setattr(ev_mod, "evaluate", evaluate)
    monkeypatch.setattr(train_mod.Trainer, "save_checkpoint", save)
    monkeypatch.setattr(train_mod.Trainer, "_eval_async_drain", drain)
    return rec


def _run_both(case, tmp_path_factory):
    """Run both Trainers on CASES[case] once per module; returns their logs,
    metrics and results dirs."""
    if case in _RUNS:
        return _RUNS[case]
    out = {}
    for pkg in ("jax", "torch"):
        tmp = tmp_path_factory.mktemp(f"{case}_{pkg}")
        jcfg = tiny_cfg(tmp, **CASES[case])
        gate = threading.Event() if jcfg.async_eval else None
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "jax":
                rec = _record(mp, jtrain, jev, "train_iter_packed",
                              beta_at=-2, prev_at=7, gate=gate)
                tr = jtrain.Trainer(jcfg)
            else:
                rec = _record(mp, ttrain, tev, "train_iter_sharded",
                              beta_at=-3, prev_at=7, gate=gate)
                tr = ttrain.Trainer(TorchConfig(**dataclasses.asdict(jcfg)),
                                    device="cpu")
            metrics = tr.run()
        rec.update(T=tr.T, metrics=metrics, dir=tr.results_dir,
                   iters_per_learn=tr.iters_per_learn,
                   settle=len(tr._settle_q))
        out[pkg] = rec
    _RUNS[case] = out
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_matches_jax_trainer(case, tmp_path_factory):
    runs = _run_both(case, tmp_path_factory)
    j, t = runs["jax"], runs["torch"]
    assert t["iters"] == j["iters"]
    assert t["saves"] == j["saves"]
    assert t["metrics"]["steps"] == j["metrics"]["steps"]
    assert t["evals"] == j["evals"] == len(j["metrics"]["steps"])
    assert t["T"] == j["T"] >= CASES[case].get("total_steps", 400)
    # The configs exercise what they are for.
    assert any(n for n, _, _ in j["iters"]) and any(s for _, _, s in j["iters"])
    if case == "iters_per_learn_2":
        assert t["iters_per_learn"] == 2
        assert any(not n for n, _, _ in j["iters"][20:])  # learning, no round
    if "memory_path" in CASES[case]:
        assert {name for _, name, _ in j["saves"]} >= {"memory_checkpoint.npz"}
        for _, name, _ in t["saves"]:
            assert os.path.exists(os.path.join(t["dir"], name))


@pytest.mark.parametrize("case", ["pipeline_1", "pipeline_2", "tiny"])
def test_pipelined_actions_lag_as_jax(case, tmp_path_factory):
    """The iteration whose actions each iteration executes: the previous
    one without the pipeline; pipelined, after a start-up transient of the
    first actions, the one depth + 1 back, as in the JAX Trainer
    (train.py:1053-1082). The settle window bounds the unsettled
    iterations."""
    runs = _run_both(case, tmp_path_factory)
    j, t = runs["jax"], runs["torch"]
    assert t["lag"] == j["lag"]
    depth = CASES[case].get("pipeline_depth", 1)
    steady = depth + 1 if CASES[case].get("pipeline_actor") else 1
    assert set(t["lag"][depth + 2:]) == {steady}
    assert t["settle"] <= CASES[case].get("settle_window", 2)


@pytest.mark.parametrize("case", ["async_coalesce", "async_workers"])
def test_async_eval_schedule_matches_jax(case, tmp_path_factory):
    """Which evaluations run, which are skipped (metrics['skipped_evals']),
    the forced final one at the end-of-run T, and results applied in
    submission order although they finish out of order."""
    runs = _run_both(case, tmp_path_factory)
    j, t = runs["jax"], runs["torch"]
    steps = t["metrics"]["steps"]
    assert steps == j["metrics"]["steps"] == sorted(steps)
    assert (t["metrics"].get("skipped_evals")
            == j["metrics"].get("skipped_evals"))
    assert steps[-1] == t["T"]
    if case == "async_coalesce":  # one runs, one waits, the rest skip
        assert len(steps) == 3 and steps[:2] == [64, 68]
        assert t["metrics"]["skipped_evals"] == list(range(96, 257, 32))
    else:  # up to four wait besides the three running
        assert len(steps) >= 6
    with open(os.path.join(t["dir"], "metrics.json")) as f:
        assert json.load(f) == t["metrics"]


@pytest.mark.parametrize("case", ["iters_per_learn_2", "tiny"])
def test_act_noise_is_held_between_redraws_as_jax(case, tmp_path_factory):
    """JAX's act reuses agent.noise_key until reset_noise; the port's
    Trainer holds its act draw for the same iterations."""
    runs = _run_both(case, tmp_path_factory)
    j_same = [np.array_equal(a, b) for a, b in zip(runs["jax"]["act"],
                                                   runs["jax"]["act"][1:])]
    t_same = [all(torch.equal(a[k][0], b[k][0]) and torch.equal(a[k][1],
                                                               b[k][1])
                  for k in a)
              for a, b in zip(runs["torch"]["act"], runs["torch"]["act"][1:])]
    assert t_same == j_same
    if case == "iters_per_learn_2":  # held across pairs, redrawn between
        assert any(t_same) and not all(t_same)
    else:
        assert not any(t_same)


def test_training_writes_metrics_plots_and_best_model(tmp_path_factory):
    t = _run_both("tiny", tmp_path_factory)["torch"]
    metrics, res = t["metrics"], t["dir"]
    cfg = tiny_cfg(".")
    assert len(metrics["rewards"][0]) == cfg.evaluation_episodes
    assert len(metrics["Qs"][0]) == cfg.evaluation_size
    for name in ("metrics.json", "Reward.html", "Q.html", "model.npz"):
        assert os.path.exists(os.path.join(res, name)), name
    with open(os.path.join(res, "metrics.json")) as f:
        assert json.load(f) == metrics
    assert metrics["best_avg_reward"] == max(np.mean(r)
                                             for r in metrics["rewards"])


def test_capacity_guard_raises_as_jax(tmp_path):
    kw = dict(num_envs=64, memory_capacity=64 * 10)
    with pytest.raises(ValueError) as want:
        jtrain.Trainer(tiny_cfg(tmp_path, **kw))
    with pytest.raises(ValueError) as got:
        ttrain.Trainer(TorchConfig(**dataclasses.asdict(
            tiny_cfg(tmp_path, **kw))), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("flag", ["sequential_per", "pipeline_actor",
                                  "async_eval", "delta_uploads"])
def test_unported_side_paths_raise(flag, tmp_path):
    """No side path raises any more: the Trainer takes the four
    single-process side paths (data parallelism has tests of its own in
    test_torch_port_parallel.py)."""
    cfg = TorchConfig(**dataclasses.asdict(tiny_cfg(tmp_path)))
    tr = ttrain.Trainer(cfg.replace(**{flag: True}), device="cpu")
    assert getattr(tr.cfg, flag)


def test_configs_are_the_same_dataclass():
    assert ([f.name for f in dataclasses.fields(TorchConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
