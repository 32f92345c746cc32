"""The port's data-parallel and multi-process training
(rainbow_tpu_torch.parallel, the Trainer's sharded path, cli.main with
--process-count) against the JAX package's make_distributed_learn on the
virtual CPU devices of tests/conftest.py, on the CPU through the kernels'
plain versions.

JAX draws inside its round; the tests recompute those draws from the same
keys and inject them, one dict per shard (``_batched_draws``,
``_sequential_draws``): ``k_local, k_noise = split(key)``, then
``fold_in(k_local, shard)``, as parallel/learner.py:74-79 does.

Tolerances, as in test_torch_port_learner.py and for the same reasons:
params after the round to lr/100 (and every tensor moved by more), the
loss and the priorities (loss^ω) to 1e-5, integer work exact. The port
against itself (one process with two shards, two gloo processes with one
each, the mean of the local gradients done by hand) is exact: the same
float32 ops in the same order, and a sum of two is commutative.

This file is also its own worker: ``python tests/test_torch_port_parallel.py
JOB RANK WORLD PORT DIR`` joins a gloo group on 127.0.0.1:PORT and runs JOB
(``_round_job``, ``_trainer_job``). A worker imports neither JAX nor the
JAX package. Every spawned pair has its own timeout and is killed when it
expires.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import rainbow_tpu_torch
from rainbow_tpu_torch import agent as tag
from rainbow_tpu_torch.models.dqn import forward_head
from rainbow_tpu_torch.parallel import learner as pl
from rainbow_tpu_torch.parallel.mesh import init_distributed, make_mesh
from rainbow_tpu_torch.replay import prioritized as trp

WORKER = __name__ == "__main__"
if not WORKER:  # the JAX side; a spawned worker runs the port alone
    import jax
    import jax.numpy as jnp

    import rainbow_tpu
    from rainbow_tpu import agent as jag
    from rainbow_tpu.models import dqn as jdqn
    from rainbow_tpu.parallel.learner import (make_distributed_learn,
                                              shard_states)
    from rainbow_tpu.parallel.mesh import make_mesh as jmake_mesh
    from rainbow_tpu.replay import prioritized as jrp

    from rainbow_tpu_torch import train as ttrain
    from rainbow_tpu_torch.convert import opt_state_from_jax

    from test_torch_port_learner import (F32, _assert_agent_close,
                                         _eps_to_torch, _flat, _t)

A, C, BATCH, ENVS_PER_SHARD = 3, 32, 8, 2
SPAWN_TIMEOUT_S = 60
HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the cores, and these
    tests' small ops slow down under thread contention; the results do not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_cfg(n, seq=False):
    return rainbow_tpu_torch.canonical(
        num_envs=n * ENVS_PER_SHARD, memory_capacity=n * ENVS_PER_SHARD * C,
        hidden_size=32, batch_size=BATCH, sequential_per=seq)


def _fields(e, seed=7, index=9):
    """A random ring of e envs (after test_torch_port_learner._replay):
    episode starts about every 6 steps, priorities with some zeros."""
    rng = np.random.default_rng(seed)
    ts = np.zeros((e, C), np.int32)
    for i in range(e):
        t = 0
        for c in range(C):
            ts[i, c] = t
            t = 0 if rng.random() < 0.17 else t + 1
    pr = rng.gamma(2.0, 1.0, (e, C)).astype(np.float32)
    pr[rng.random((e, C)) < 0.1] = 0.0
    return dict(
        frames=rng.integers(0, 256, (e, C, 84 * 84)).astype(np.uint8),
        actions=rng.integers(0, A, (e, C)).astype(np.int32),
        rewards=rng.normal(size=(e, C)).astype(np.float32),
        timesteps=ts, nonterminal=rng.random((e, C)) > 0.1, priorities=pr,
        index=np.int32(index), full=np.bool_(True),
        t=rng.integers(0, 9, e).astype(np.int32),
        max_priority=np.float32(pr.max()))


def _shard_reps(fields, n, device="cpu"):
    """The ring's env rows split into n replay shards."""
    e = fields["priorities"].shape[0] // n
    return [trp.ReplayState(**{
        k: torch.from_numpy(np.array(v[s * e:(s + 1) * e] if np.ndim(v)
                                     else v)).to(device)
        for k, v in fields.items()}) for s in range(n)]


# ------------------------------------------------------ against JAX -------

def _jax_round(jcfg, ja, fields, n, nl, beta, key):
    mesh = jmake_mesh(jax.devices()[:n])
    rep = jrp.init_replay(jcfg.num_envs, C).replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    agent, rep, _ = shard_states(mesh, ja, rep,
                                 jnp.zeros((jcfg.num_envs, 1, 1, 1)))
    learn = make_distributed_learn(mesh, jcfg, A, num_learns=nl)
    return learn(agent, rep, jnp.float32(beta), key)


def _batched_draws(jcfg, key, n, nl):
    """JAX's batched round's draws (learner.py:74-79), one dict a shard."""
    bs = BATCH // n
    k_local, k_noise = jax.random.split(key)
    online = _eps_to_torch(jdqn.draw_noise(jcfg, A, k_noise, lead=(nl,)))
    out = []
    for d in range(n):
        k_sample, k_target = jax.random.split(jax.random.fold_in(k_local, d))
        out.append({
            "u": _t(jax.random.uniform(k_sample, (nl * bs,), jnp.float32)),
            "target": _eps_to_torch(jdqn.draw_noise(jcfg, A, k_target,
                                                    lead=(nl * bs,))),
            "online": online})
    return out


def _sequential_draws(jcfg, ja, key, n, nl):
    """JAX's sequential round's draws (learner.py:125-145): per update the
    noise key folded, the sample key folded with the shard, the target key
    split off the replicated rng."""
    bs = BATCH // n
    noise_key, rng, us, online, target = ja.noise_key, ja.rng, [], [], []
    for k in jax.random.split(key, nl):
        noise_key = jax.random.fold_in(noise_key, 1)
        rng, k_target = jax.random.split(rng)
        online.append(jdqn.draw_noise(jcfg, A, noise_key))
        target.append(jdqn.draw_noise(jcfg, A, k_target))
        us.append([np.asarray(jax.random.uniform(jax.random.fold_in(k, d),
                                                 (bs,), jnp.float32))
                   for d in range(n)])
    stack = lambda per: {name: tuple(_t(np.stack([np.asarray(p[name][h])
                                                  for p in per]))
                                     for h in (0, 1)) for name in per[0]}
    return [{"u": _t(np.stack([u[d] for u in us])), "online": stack(online),
             "target": stack(target)} for d in range(n)]


def _port_agents(jcfg, tcfg, ja, n):
    ta = tag.AgentState(
        params=_flat(ja.params), target_params=_flat(ja.target_params),
        opt_state=opt_state_from_jax(jax.tree.map(np.asarray, ja.opt_state),
                                     device="cpu"),
        generator=torch.Generator().manual_seed(0))
    return pl.replicate(ta, ["cpu"] * n)


def _assert_replicas_equal(agents):
    for a in agents[1:]:
        for tree in ("params", "target_params"):
            for k, v in getattr(agents[0], tree).items():
                assert torch.equal(getattr(a, tree)[k], v), (tree, k)
        for k, v in agents[0].opt_state.nu.items():
            assert torch.equal(a.opt_state.nu[k], v), k
        assert a.step == agents[0].step


@pytest.mark.parametrize("seq", [False, True], ids=["batched", "sequential"])
@pytest.mark.parametrize("n", [2, 4])
def test_distributed_round_matches_jax(n, seq):
    """make_distributed_learn on an n-device mesh against distributed_round
    over n shards in one process, on JAX's draws."""
    tcfg = _torch_cfg(n, seq)
    jcfg = rainbow_tpu.canonical(**{
        k: getattr(tcfg, k) for k in ("num_envs", "memory_capacity",
                                      "hidden_size", "batch_size",
                                      "sequential_per")})
    ja = jag.init_agent(jax.random.key(n), jcfg, A)
    fields = _fields(jcfg.num_envs)
    nl, beta, key = 2, 0.55, jax.random.key(40 + n)
    draws = (_sequential_draws(jcfg, ja, key, n, nl) if seq
             else _batched_draws(jcfg, key, n, nl))
    agents = _port_agents(jcfg, tcfg, ja, n)
    reps = _shard_reps(fields, n)
    params0 = {k: v.clone() for k, v in agents[0].params.items()}
    ja2, j2, jloss = _jax_round(jcfg, ja, fields, n, nl, beta, key)
    loss = pl.distributed_round(agents, reps, tcfg, A, nl, beta,
                                pl.Shards(["cpu"] * n, tcfg), draws)
    np.testing.assert_allclose(loss.item(), float(jloss), **F32)
    for a in agents:
        _assert_agent_close(a, ja2, params0, nl)
    _assert_replicas_equal(agents)
    got = np.concatenate([r.priorities.numpy() for r in reps])
    np.testing.assert_allclose(got, np.asarray(j2.priorities), **F32)
    assert (got != fields["priorities"]).sum() >= nl * BATCH // 2
    for r in reps:
        np.testing.assert_allclose(float(r.max_priority),
                                   float(j2.max_priority), **F32)


@pytest.mark.parametrize("seq", [False, True], ids=["batched", "sequential"])
def test_distributed_grads_equal_mean_of_local_grads(seq):
    """After tests/test_parallel.py:70: one update over two shards equals
    clip + Adam of the mean of the two shards' gradients, each computed
    alone on its shard's batch with the IS weights renormalised by the
    larger weights_max, bit for bit."""
    n, beta = 2, 0.5
    cfg = _torch_cfg(n, seq)
    bs = BATCH // n
    fields = _fields(cfg.num_envs, seed=11)
    agent = tag.init_agent(cfg, A, 5, "cpu")
    host = pl.replicate(agent, ["cpu", "cpu"])[1]
    g = torch.Generator().manual_seed(3)
    online = tag.reset_noise(agent, cfg, A, (1,))
    draws = []
    for _ in range(n):
        d = {"u": torch.rand((1, bs) if seq else (bs,), generator=g),
             "online": online}
        d["target"] = (online if seq else
                       tag.reset_noise(agent, cfg, A, (bs,)))
        draws.append(d)
    reps = _shard_reps(fields, n)
    pl.distributed_round([agent, pl.replicate(agent, ["cpu", "cpu"])[1]],
                         reps, cfg, A, 1, beta, pl.Shards(["cpu"] * n, cfg),
                         draws)
    grads, wmax, batches = [], [], []
    for rep, d in zip(_shard_reps(fields, n), draws):
        kw = dict(history=4, n_step=3, discount=cfg.discount)
        if seq:
            b = trp.sample(rep, beta, batch_size=bs, u=d["u"][0], **kw)
        else:
            big = trp.sample_many(rep, beta, num_batches=1, batch_size=bs,
                                  u=d["u"], **kw)
            b = {k: v[0] for k, v in big.items()}
        wmax.append(b["weights_max"])
        batches.append(b)
    gmax = torch.stack(wmax).amax()
    eps0 = {k: (x[0], y[0]) for k, (x, y) in online.items()}
    for b, d, w in zip(batches, draws, wmax):
        b["weights"] = b["weights"] * (w / gmax)
        if seq:
            gr, _ = tag.compute_update(host, cfg, A, b, {"online": eps0,
                                                         "target": eps0})
        else:
            for k in ("states", "next_states"):
                b[k] = trp.states_to_float(b[k])
            with torch.no_grad():
                pns = forward_head(host.target_params, cfg, A,
                                   b["next_states"], dist="probs",
                                   noise_eps=d["target"]).dist
            gr, _ = tag.compute_update_pretarget(host, cfg, A, b, pns, eps0)
        grads.append(gr)
    tag.apply_grads(host, cfg, {k: (grads[0][k] + grads[1][k]) / n
                                for k in grads[0]})
    for k, v in host.params.items():
        assert torch.equal(agent.params[k], v), k


def test_nan_loss_on_one_shard_makes_every_max_priority_nan():
    """A NaN loss on one shard (NaN rewards in its rows) gives a NaN
    max_priority on every shard, as update_priorities gives one device
    (jnp.maximum; K7 on the card). JAX's pmax on its CPU backend drops
    that NaN instead: its max_priority stays finite on both devices while
    shard 1 holds NaN priorities. A known difference, pinned here
    (ROADMAP.md Queue 3)."""
    n = 2
    tcfg = _torch_cfg(n)
    jcfg = rainbow_tpu.canonical(num_envs=tcfg.num_envs,
                                 memory_capacity=tcfg.memory_capacity,
                                 hidden_size=32, batch_size=BATCH)
    fields = _fields(tcfg.num_envs, seed=3)
    fields["rewards"][ENVS_PER_SHARD:] = np.nan
    ja = jag.init_agent(jax.random.key(1), jcfg, A)
    key = jax.random.key(2)
    _, j2, _ = _jax_round(jcfg, ja, fields, n, 1, 0.5, key)
    assert np.isnan(np.asarray(j2.priorities)[ENVS_PER_SHARD:]).any()
    assert np.isfinite(float(j2.max_priority))  # pmax dropped the NaN
    agents = _port_agents(jcfg, tcfg, ja, n)
    reps = _shard_reps(fields, n)
    pl.distributed_round(agents, reps, tcfg, A, 1, 0.5,
                         pl.Shards(["cpu"] * n, tcfg),
                         _batched_draws(jcfg, key, n, 1))
    np.testing.assert_array_equal(
        np.isnan(np.concatenate([r.priorities.numpy() for r in reps])),
        np.isnan(np.asarray(j2.priorities)))
    assert all(torch.isnan(r.max_priority) for r in reps)


def test_shards_check_the_batch_and_the_mesh_defaults():
    with pytest.raises(ValueError, match="must divide over 3 shards"):
        pl.Shards(["cpu"] * 3, _torch_cfg(1))
    assert make_mesh(None, "cpu") == [torch.device("cpu")]
    assert make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    init_distributed(None, 1, None, "cpu")  # one process: nothing to join
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(None, 2, 0, "cpu")
    seeds = {pl.shard_seed(123, s, step, k) for s in range(4)
             for step in (0, 256) for k in (pl.UNIFORMS, pl.TARGET_NOISE)}
    assert len(seeds) == 16 and max(seeds) < 2 ** 63


# ------------------------------------------------- spawned gloo pairs -----

def _spawn_pair(job, tmp_path):
    """Run JOB in two worker processes of one gloo group; returns each
    rank's standard output. Both are killed if either outlives the
    timeout."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, HERE, job, str(r), "2", str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    outs, deadline = [], time.monotonic() + SPAWN_TIMEOUT_S
    try:  # one deadline for the pair: a rank's wait takes what is left
        for p in procs:
            out, _ = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{job}: a rank outlived {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def _rounds(agents, reps, cfg, shards):
    """A batched round, a sequential round and a round with NaN rewards on
    the last shard of the group, with the port's own draws; returns each
    round's (loss, params, priorities and max_priority of every local
    shard) as numpy."""
    out = []
    for i, c in enumerate((cfg, cfg.replace(sequential_per=True), cfg)):
        if i == 2 and shards.index(len(reps) - 1) == shards.count - 1:
            reps[-1].rewards.fill_(float("nan"))
        loss = pl.distributed_round(agents, reps, c, A, 2, 0.5, shards)
        out.append({"loss": loss.numpy(),
                    **{f"p/{k}": v.numpy().copy()
                       for k, v in agents[0].params.items()},
                    **{f"prio{shards.index(s)}": r.priorities.numpy().copy()
                       for s, r in enumerate(reps)},
                    **{f"maxp{shards.index(s)}": r.max_priority.numpy()
                       for s, r in enumerate(reps)}})
    return out


def _round_job(rank, world, tmp):
    cfg = _torch_cfg(world)
    reps = _shard_reps(_fields(cfg.num_envs), world)[rank:rank + 1]
    agents = [tag.init_agent(cfg, A, 9, "cpu")]
    for i, res in enumerate(_rounds(agents, reps, cfg,
                                    pl.Shards(["cpu"], cfg))):
        np.savez(os.path.join(tmp, f"round{i}_rank{rank}.npz"), **res)


def test_two_gloo_processes_run_the_round_of_one_process_with_two_shards(
        tmp_path):
    """Two ranks of one shard each, over gloo, against one process holding
    both shards: the same batched, sequential and NaN rounds, bit for bit;
    the NaN of the last shard reaches both ranks' max_priority."""
    _spawn_pair("round", tmp_path)
    cfg = _torch_cfg(2)
    reps = _shard_reps(_fields(cfg.num_envs), 2)
    agent = tag.init_agent(cfg, A, 9, "cpu")
    # One thread here as in the workers (_one_thread): the CPU
    # convolutions' sums follow the thread count.
    assert torch.get_num_threads() == 1
    want = _rounds(pl.replicate(agent, ["cpu", "cpu"]), reps, cfg,
                   pl.Shards(["cpu", "cpu"], cfg))
    for i, w in enumerate(want):
        for rank in range(2):
            with np.load(tmp_path / f"round{i}_rank{rank}.npz") as got:
                for k in got.files:
                    np.testing.assert_array_equal(got[k], w[k],
                                                  err_msg=f"{i} {k}")
    assert np.isfinite(want[1]["loss"]) and np.isnan(want[2]["maxp0"])


_TRAINER_ARGV = [
    "--preset", "data-efficient", "--num-envs", "8", "--memory-capacity",
    "1024", "--batch-size", "8", "--T-max", "400", "--learn-start", "64",
    "--replay-frequency", "4", "--target-update", "128",
    "--evaluation-interval", "200", "--evaluation-episodes", "2",
    "--evaluation-size", "16", "--architecture", "data-efficient",
    "--hidden-size", "32", "--multi-step", "3", "--env-backend", "fake",
    "--max-episode-length", "400", "--id", "mh", "--memory", "save-replay",
    "--pipeline-actor", "--pipeline-depth", "2", "--process-count", "2"]


def _trainer_job(rank, world, port, tmp):
    """After tests/multihost_trainer_worker.py: the Trainer through cli.main
    (per-rank env slice and replay shard, the evaluation, a replay-bearing
    save), then an exact restore into a new Trainer from the base path and
    200 more steps. Each rank runs in a directory of its own, so what it
    writes is told apart."""
    from rainbow_tpu_torch import cli
    from rainbow_tpu_torch.parallel.multihost import (agent_tensors,
                                                      tensors_agree)
    from rainbow_tpu_torch.train import Trainer

    os.makedirs(os.path.join(tmp, f"rank{rank}"))
    os.chdir(os.path.join(tmp, f"rank{rank}"))
    tr = cli.main(_TRAINER_ARGV + ["--process-id", str(rank),
                                   "--coordinator", f"127.0.0.1:{port}"],
                  device="cpu")
    assert tr.multi_process and tr.envs_local == 4 and tr.T == 400
    assert tr.metrics["steps"] == [200, 400], tr.metrics["steps"]
    tr.save_checkpoint("final.npz", include_replay=True)
    tr2 = Trainer(tr.cfg.replace(run_id="mh2", total_steps=600),
                  device="cpu")
    tr2.restore_checkpoint(os.path.join("results", "mh", "final.npz"))
    assert tr2.T == tr.T and tr2.metrics == tr.metrics
    for k, v in agent_tensors(tr.agent).items():
        assert torch.equal(agent_tensors(tr2.agent)[k], v), k
    for k in ("frames", "priorities", "index", "max_priority", "t"):
        assert torch.equal(getattr(tr2.rep, k), getattr(tr.rep, k)), k
    assert tr2.agent.noise == tr.agent.noise
    tr2.run()
    assert tr2.T == 600 and tr2.metrics["steps"] == [200, 400, 600]
    agree = tensors_agree(agent_tensors(tr2.agent))
    probe = float(tr2.agent.params["fc_z_a.bias_mu"][0])
    print(f"TRAINER-OK rank={rank} agree={agree} probe={probe!r}",
          flush=True)


def test_two_gloo_processes_train_restore_and_agree(tmp_path):
    """cli.main with --process-count 2 on two gloo ranks: both train, save
    per-rank checkpoints and restore them exactly; their params stay
    bit-identical; only rank 0 writes model.npz, metrics.json and the
    plots."""
    outs = _spawn_pair("trainer", tmp_path)
    lines = [next(l for l in o.splitlines() if l.startswith("TRAINER-OK"))
             for o in outs]
    assert all("agree=True" in l for l in lines), lines
    assert lines[0].split("probe=")[1] == lines[1].split("probe=")[1]
    files = [sorted(os.listdir(tmp_path / f"rank{r}" / "results" / d))
             for r in range(2) for d in ("mh", "mh2")]
    assert files[2] == ["final.npz.proc1-of-2",
                        "memory_checkpoint.npz.proc1-of-2"]
    assert files[3] == ["memory_checkpoint.npz.proc1-of-2"]
    for name in ("metrics.json", "model.npz", "Reward.html", "Q.html",
                 "final.npz.proc0-of-2", "memory_checkpoint.npz.proc0-of-2"):
        assert name in files[0], (name, files[0])


# ------------------------------------------------------------ Trainer -----

def _dp_cfg(tmp_path, **kw):
    return rainbow_tpu_torch.data_efficient(**{**dict(
        num_envs=8, memory_capacity=8 * 128, batch_size=8, total_steps=320,
        learn_start=64, replay_frequency=4, target_update=128,
        evaluation_interval=160, evaluation_episodes=2, evaluation_size=10,
        architecture="data-efficient", hidden_size=32, multi_step=3,
        env_backend="fake", results_dir=str(tmp_path), run_id="dp",
        max_episode_length=400, data_parallel=True), **kw})


def test_data_parallel_trainer(tmp_path, monkeypatch):
    """After tests/test_parallel.py:198: data_parallel over two shards in
    one process, one sharded iteration per loop iteration; the replicas
    stay bit-identical; a replay-bearing checkpoint (the shards' rows as
    one ring) restores exactly into a data-parallel and a single-device
    Trainer."""
    cfg = _dp_cfg(tmp_path)
    tr = ttrain.Trainer(cfg, devices=["cpu", "cpu"], device="cpu")
    assert tr.shards.count == 2 and len(tr.agents) == 2
    assert tr.envs_per_shard == 4
    calls = []
    real = ttrain.train_iter_sharded
    monkeypatch.setattr(ttrain, "train_iter_sharded",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    metrics = tr.run()
    assert tr.T == 320 and len(calls) == tr.T // cfg.num_envs
    assert sum(calls) == tr.agent.step > 0 and metrics["steps"] == [160, 320]
    _assert_replicas_equal(tr.agents)
    tr.save_checkpoint("dp.npz", include_replay=True)
    path = os.path.join(tr.results_dir, "dp.npz")
    for devices, extra in ((["cpu", "cpu"], {}),
                           (None, dict(data_parallel=False))):
        tr2 = ttrain.Trainer(cfg.replace(run_id="dp2", **extra),
                             devices=devices, device="cpu")
        tr2.restore_checkpoint(path)
        _assert_replicas_equal(tr2.agents)
        for k, v in tr.agent.params.items():
            assert torch.equal(tr2.agent.params[k], v), k
        for k in ("frames", "priorities", "t"):
            assert torch.equal(
                torch.cat([getattr(r, k) for r in tr2.reps]),
                torch.cat([getattr(r, k) for r in tr.reps])), k
        assert tr2.T == tr.T and tr2.agent.step == tr.agent.step


def test_a_rank_restores_its_rows_of_a_single_process_checkpoint(tmp_path):
    """A rank without a checkpoint of its own restores the base file and
    takes its own env rows of that ring (one process, as rank 1 of a fake
    world of two)."""
    cfg = _dp_cfg(tmp_path, data_parallel=False, memory_path="m")
    tr = ttrain.Trainer(cfg, device="cpu")
    for k in ("frames", "priorities", "t"):
        v = getattr(tr.rep, k)
        v.copy_(torch.arange(v.numel()).reshape(v.shape).to(v.dtype))
    tr.save_checkpoint("one.npz", include_replay=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "world", lambda: (1, 2))
        mp.setattr(pl, "world", lambda: (1, 2))
        rank = ttrain.Trainer(cfg, device="cpu")
        assert rank.multi_process and rank.envs_local == 4
        rank.restore_checkpoint(os.path.join(tr.results_dir, "one.npz"))
    for k in ("frames", "priorities", "t"):
        assert torch.equal(getattr(rank.rep, k), getattr(tr.rep, k)[4:]), k
    for k, v in tr.agent.params.items():
        assert torch.equal(rank.agent.params[k], v), k


def test_more_than_one_process_needs_divisible_envs_and_dense_uploads():
    """The multi-process guards of JAX train.py:506-514, checked before
    any env is made (one process, so a fake world of two)."""
    cfg = _dp_cfg("unused", num_envs=9, data_parallel=False)
    tr = ttrain.Trainer.__new__(ttrain.Trainer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "world", lambda: (1, 2))
        with pytest.raises(ValueError, match="must divide over 2 processes"):
            tr.__init__(cfg, device="cpu")
        with pytest.raises(ValueError, match="single-process mode"):
            tr.__init__(cfg.replace(num_envs=8, delta_uploads=True),
                        device="cpu")


def _worker(argv):
    job, rank, world, port, tmp = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if job == "round":
        init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
        _round_job(rank, world, tmp)
    else:
        _trainer_job(rank, world, port, tmp)
    torch.distributed.destroy_process_group()


if WORKER:
    _worker(sys.argv[1:])
