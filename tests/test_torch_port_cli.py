"""The port's command line and sweep (rainbow_tpu_torch.cli, .sweep) against
the JAX package's, on the CPU with the fake env."""
import dataclasses
import json
import os

import pytest
import torch

from rainbow_tpu import cli as jcli

from rainbow_tpu_torch import cli as tcli
from rainbow_tpu_torch import sweep as tsweep

TINY = ["--num-envs", "4", "--memory-capacity", "1024", "--batch-size", "16",
        "--learn-start", "64", "--replay-frequency", "4", "--target-update",
        "128", "--evaluation-episodes", "2", "--evaluation-size", "20",
        "--hidden-size", "32", "--multi-step", "3", "--env-backend", "fake",
        "--max-episode-length", "400", "--architecture", "data-efficient"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these runs are chains of tiny ops, which several
    test workers sharing the cores would otherwise slow by thread
    contention; the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("argv", [
    # tests/test_train_smoke.py::test_cli_parses_and_overrides
    ["--preset", "data-efficient", "--game", "breakout", "--T-max", "5000",
     "--num-envs", "16", "--noisy-std", "0.2"],
    # tests/test_train_smoke.py::test_throughput_preset_preserves_sample_ratio
    ["--preset", "throughput", "--batch-size", "512"],
    # one per preset, with the flags of every kind
    ["--preset", "canonical", "--num-envs", "1024", "--learn-start", "32768",
     "--memory", "m", "--no-compress-memory", "--per-env-noise",
     "--adam-mu-dtype", "bfloat16", "--V-min", "-5", "--id", "x"],
    ["--preset", "data-efficient", "--evaluate", "--model", "m.npz",
     "--resume", "c.npz", "--compute-dtype", "bfloat16"],
    ["--preset", "throughput", "--sequential-per", "--pipeline-actor",
     "--memory-save-interval", "100", "--profile", "--render"],
    [],
])
def test_parse_config_matches_jax(argv):
    jcfg, jargs = jcli.parse_config(argv)
    tcfg, targs = tcli.parse_config(argv)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert vars(targs) == vars(jargs)


def test_parser_flags_match_jax():
    """Every flag as the JAX package's, with one more architecture: the
    port's --architecture also takes impala-x4, which the JAX package has
    no torso for."""
    def flags(p, more=()):
        return sorted((a.dest, tuple(a.option_strings), a.default,
                       tuple(sorted((*(a.choices or ()), *more))
                             if a.dest == "architecture" else
                             (a.choices or ()))) for a in p._actions)
    assert flags(tcli.build_parser()) == flags(jcli.build_parser(),
                                               ("impala-x4",))


def test_main_trains_then_evaluates_the_best_model(tmp_path, capsys,
                                                   monkeypatch):
    res = str(tmp_path)
    monkeypatch.chdir(res)  # the results dir is relative, as in JAX's
    tr = tcli.main(TINY + ["--T-max", "256", "--evaluation-interval", "128",
                           "--id", "run"], device="cpu")
    assert tr.T == 256 and tr.metrics["steps"] == [128, 256]
    model = os.path.join(res, "results", "run", "model.npz")
    assert os.path.exists(model)
    tr2 = tcli.main(TINY + ["--evaluate", "--model", model, "--id", "ev"],
                    device="cpu")
    assert tr2.T == 0 and tr2.metrics["steps"] == []
    assert "Avg. reward:" in capsys.readouterr().out.splitlines()[-1]


def test_main_takes_the_side_paths(tmp_path, monkeypatch):
    """The four single-process side paths together through the command
    line; the fake env has no step_delta, so the uploads stay dense."""
    monkeypatch.chdir(tmp_path)
    tr = tcli.main(TINY + ["--T-max", "192", "--evaluation-interval", "128",
                           "--sequential-per", "--delta-uploads",
                           "--pipeline-actor", "--pipeline-depth", "2",
                           "--async-eval", "--id", "side"], device="cpu")
    assert tr.T == 192 and tr.metrics["steps"] == [128]
    assert tr.upload_forms == {"delta": 0, "dense": tr.T // tr.cfg.num_envs}
    assert tr.agent.step > 0


@pytest.mark.parametrize("argv", [[], ["--coordinator", "127.0.0.1:1"],
                                  ["--process-id", "0"]])
def test_main_needs_a_coordinator_and_an_id_for_more_than_one_process(argv):
    """--process-count 2 without --coordinator or --process-id raises a
    clear error before anything starts (two gloo processes train in
    test_torch_port_parallel.py)."""
    with pytest.raises(ValueError, match="--coordinator HOST:PORT"):
        tcli.main(["--process-count", "2", "--env-backend", "fake", *argv],
                  device="cpu")
    assert not torch.distributed.is_initialized()


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(TINY + ["--T-max", "8"])


def test_sweep_writes_its_tables(tmp_path, monkeypatch):
    monkeypatch.chdir(str(tmp_path))
    results = tsweep.run_sweep(TINY + ["--games", "pong", "breakout",
                                       "--T-max", "96", "--learn-start",
                                       "32", "--evaluation-interval", "96",
                                       "--id", "sw"], device="cpu")
    assert sorted(results) == ["breakout", "pong"]
    out = os.path.join(str(tmp_path), "results", "sw")
    with open(os.path.join(out, "sweep.json")) as f:
        assert json.load(f) == results
    with open(os.path.join(out, "sweep.md")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 4 and lines[2].startswith("| pong |")
    for game in results:
        assert results[game]["evals"] == 1
        assert os.path.exists(os.path.join(str(tmp_path), "results",
                                           f"sw-{game}", "metrics.json"))
