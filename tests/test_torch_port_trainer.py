"""The port's Trainer (rainbow_tpu_torch.train.Trainer) against the JAX
package's, on the CPU with the fake env.

Both Trainers run the same configs, sized like tests/test_train_smoke.py::
tiny_cfg, and each package's ``train_iter_packed``, ``evaluate`` and
``Trainer.save_checkpoint`` are wrapped to record what the schedule decided
in every iteration: (num_learns, β, sync_target), each save's (T, name,
include_replay), and which iterations redrew the act noise. The two
packages draw different random numbers, so the learning itself differs;
the schedule must not. β is compared exactly: both compute it in Python
floats and pass it as np.float32.
"""
import dataclasses
import json
import os

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


def _record(monkeypatch, train_mod, ev_mod, beta_at):
    """Wrap the package's iteration, evaluation and save; returns the log."""
    rec = {"iters": [], "saves": [], "evals": 0, "act": []}
    real_iter = train_mod.train_iter_packed
    real_eval = ev_mod.evaluate
    real_save = train_mod.Trainer.save_checkpoint

    def iteration(*args):
        num_learns, beta, sync = args[2], args[beta_at], args[beta_at + 1]
        assert isinstance(beta, np.float32)
        rec["iters"].append((num_learns, float(beta), bool(sync)))
        if train_mod is jtrain:  # the key JAX's act uses after this round
            key = args[3].noise_key
            if num_learns:
                key = jax.random.fold_in(jax.random.fold_in(key, 1), 1)
            rec["act"].append(np.asarray(jax.random.key_data(key)).copy())
        else:
            rec["act"].append({k: (a.clone(), b.clone())
                               for k, (a, b) in args[-1]["act"].items()})
        return real_iter(*args)

    def evaluate(*args, **kw):
        rec["evals"] += 1
        return real_eval(*args, **kw)

    def save(self, name="checkpoint.npz", include_replay=None):
        rec["saves"].append((self.T, name, include_replay))
        return real_save(self, name, include_replay)

    monkeypatch.setattr(train_mod, "train_iter_packed", iteration)
    monkeypatch.setattr(ev_mod, "evaluate", evaluate)
    monkeypatch.setattr(train_mod.Trainer, "save_checkpoint", save)
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
        with pytest.MonkeyPatch.context() as mp:
            if pkg == "jax":
                rec = _record(mp, jtrain, jev, beta_at=-2)
                tr = jtrain.Trainer(jcfg)
            else:
                rec = _record(mp, ttrain, tev, beta_at=-3)
                tr = ttrain.Trainer(TorchConfig(**dataclasses.asdict(jcfg)),
                                    device="cpu")
            metrics = tr.run()
        rec.update(T=tr.T, metrics=metrics, dir=tr.results_dir,
                   iters_per_learn=tr.iters_per_learn)
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
    assert t["T"] == j["T"] >= 400
    # The configs exercise what they are for.
    assert any(n for n, _, _ in j["iters"]) and any(s for _, _, s in j["iters"])
    if case == "iters_per_learn_2":
        assert t["iters_per_learn"] == 2
        assert any(not n for n, _, _ in j["iters"][20:])  # learning, no round
    if case != "tiny":
        assert {name for _, name, _ in j["saves"]} >= {"memory_checkpoint.npz"}
        for _, name, _ in t["saves"]:
            assert os.path.exists(os.path.join(t["dir"], name))


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
                                  "async_eval", "delta_uploads",
                                  "data_parallel"])
def test_unported_side_paths_raise(flag, tmp_path):
    cfg = TorchConfig(**dataclasses.asdict(tiny_cfg(tmp_path)))
    with pytest.raises(NotImplementedError, match=f"{flag}.*ROADMAP"):
        ttrain.Trainer(cfg.replace(**{flag: True}), device="cpu")


def test_configs_are_the_same_dataclass():
    assert ([f.name for f in dataclasses.fields(TorchConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
