"""The port's checkpoints (rainbow_tpu_torch.checkpoint and the Trainer's
save/restore), on the CPU: round trips, exact resume, and a JAX Trainer
checkpoint imported through convert.py. The two packages' checkpoint files
are not interchangeable; only this test reads a JAX one, with the JAX
package's own loader."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_tpu import agent as jag
from rainbow_tpu import checkpoint as jckpt
from rainbow_tpu import train as jtrain
from rainbow_tpu.ops.preprocess import to_network_input as jto_network_input

from rainbow_tpu_torch import agent as tag
from rainbow_tpu_torch import checkpoint as ckpt
from rainbow_tpu_torch import train as ttrain
from rainbow_tpu_torch.config import RainbowConfig as TorchConfig
from rainbow_tpu_torch.convert import (opt_state_from_jax, params_from_jax,
                                       params_to_jax, replay_from_jax)
from rainbow_tpu_torch.models.dqn import forward_head
from rainbow_tpu_torch.ops.preprocess import to_network_input

from test_train_smoke import tiny_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: these runs are chains of tiny ops, which several
    test workers sharing the cores would otherwise slow by thread
    contention; the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"fc.weight": torch.randn(32, 16, generator=g),
                       "fc.bias": torch.zeros(16)},
            "frames": torch.arange(84, dtype=torch.uint8).repeat(64, 84),
            "flags": torch.tensor([True, False]),
            "count": torch.tensor(7, dtype=torch.int32),
            "bytes": np.frombuffer(b'{"a": 1}', np.uint8),
            "T": 1234, "beta": 0.4, "done": True}


def _assert_same(a, b):
    assert type(a) is type(b) or isinstance(a, type(b)), (type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("compress", [False, True])
def test_state_round_trip(tmp_path, compress):
    t = _tree()
    path = os.path.join(str(tmp_path), "a.npz")
    ckpt.save_state(path, t, compress=compress)
    assert not os.path.exists(path + ".tmp")
    _assert_same(ckpt.load_state(path), t)


def test_compressed_replay_is_smaller(tmp_path):
    frames = torch.arange(84, dtype=torch.uint8)[None].repeat(512, 7056 // 84)
    t = {"replay": {"frames": frames, "priorities": torch.ones(512)}}
    raw, comp = (os.path.join(str(tmp_path), n) for n in ("r.npz", "c.npz"))
    ckpt.save_state(raw, t, compress=False)
    ckpt.save_state(comp, t, compress=True)
    assert os.path.getsize(comp) < os.path.getsize(raw) / 3
    assert torch.equal(ckpt.load_state(comp)["replay"]["frames"], frames)


def test_bfloat16_leaves_are_exact(tmp_path):
    x = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    t = {"mu": x.to(torch.bfloat16), "zero": torch.zeros((), dtype=torch.bfloat16)}
    path = os.path.join(str(tmp_path), "b.npz")
    ckpt.save_state(path, t)
    _assert_same(ckpt.load_state(path), t)
    # Stored as uint16 bits, as the JAX package stores bfloat16.
    with np.load(path) as z:
        assert z["mu"].dtype == np.uint16


def test_generator_restore_gives_the_next_draw(tmp_path):
    g = torch.Generator().manual_seed(5)
    torch.rand(17, generator=g)  # advance the stream
    path = os.path.join(str(tmp_path), "g.npz")
    ckpt.save_state(path, {"g": g})
    want = torch.rand(9, generator=g)
    back = ckpt.load_state(path)["g"]
    assert isinstance(back, torch.Generator)
    assert torch.equal(torch.rand(9, generator=back), want)


def test_load_params_raises_on_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_params(os.path.join(str(tmp_path), "nope.npz"), "cpu")
    with pytest.raises(FileNotFoundError):  # as the JAX package's does
        jckpt.load_params(os.path.join(str(tmp_path), "nope.npz"))


def _port_cfg(tmp_path, **kw):
    return TorchConfig(**dataclasses.asdict(tiny_cfg(tmp_path, **kw)))


def _assert_trainers_equal(a, b):
    for name in ("params", "target_params"):
        _assert_same(getattr(b.agent, name), getattr(a.agent, name))
    _assert_same(b.agent.opt_state.mu, a.agent.opt_state.mu)
    _assert_same(b.agent.opt_state.nu, a.agent.opt_state.nu)
    assert torch.equal(b.agent.opt_state.count, a.agent.opt_state.count)
    assert b.agent.step == a.agent.step
    _assert_same(dataclasses.asdict(b.rep), dataclasses.asdict(a.rep))
    assert b.T == a.T and b.metrics == a.metrics


def test_trainer_resume_is_exact(tmp_path):
    """Full-state save and restore, as tests/test_train_smoke.py::
    test_checkpoint_resume_exact: params, Adam state, generators, replay,
    T and metrics; and both generators' next draws are the same."""
    cfg = _port_cfg(tmp_path, total_steps=200, evaluation_interval=100)
    tr = ttrain.Trainer(cfg, device="cpu")
    tr.run()
    assert tr.agent.step > 0 and tr.metrics["steps"] == [100, 200]
    tr.save_checkpoint("final.npz", include_replay=True)
    tr2 = ttrain.Trainer(cfg, device="cpu")
    tr2.restore_checkpoint(os.path.join(tr.results_dir, "final.npz"))
    _assert_trainers_equal(tr, tr2)
    for g1, g2 in ((tr.agent.generator, tr2.agent.generator),
                   (tr.eval_generator, tr2.eval_generator)):
        assert torch.equal(torch.rand(5, generator=g2),
                           torch.rand(5, generator=g1))
    # Without the replay the ring is left as it was.
    tr.save_checkpoint("agent_only.npz", include_replay=False)
    tr3 = ttrain.Trainer(cfg, device="cpu")
    tr3.restore_checkpoint(os.path.join(tr.results_dir, "agent_only.npz"))
    assert int(tr3.rep.index) == 0 and not bool(tr3.rep.priorities.any())
    _assert_same(tr3.agent.params, tr.agent.params)


def test_resumed_run_continues_the_schedule(tmp_path):
    """A run resumed at T continues with the marks recomputed from T: the
    evaluations of a resumed run are those of an uninterrupted one."""
    cfg = _port_cfg(tmp_path, total_steps=200, evaluation_interval=100)
    tr = ttrain.Trainer(cfg, device="cpu")
    tr.run()
    tr.save_checkpoint("mid.npz", include_replay=True)
    tr2 = ttrain.Trainer(cfg.replace(total_steps=304), device="cpu")
    tr2.restore_checkpoint(os.path.join(tr.results_dir, "mid.npz"))
    metrics = tr2.run()
    assert metrics["steps"] == [100, 200, 300] and tr2.T == 304


def test_jax_trainer_checkpoint_imports_bit_exact(tmp_path):
    """A JAX Trainer's checkpoint, read with the JAX package's loader,
    converted and saved in the port's format, restores into a port Trainer
    with JAX's params bit for bit, its Adam state, replay, T and metrics;
    greedy act on fixed states gives JAX's actions."""
    jcfg = tiny_cfg(os.path.join(str(tmp_path), "jax"), total_steps=200,
                    evaluation_interval=100)
    jtr = jtrain.Trainer(jcfg)
    jtr.run()
    jtr.save_checkpoint("jax.npz", include_replay=True)
    st = jckpt.load_pytree(os.path.join(jtr.results_dir, "jax.npz"))

    tcfg = TorchConfig(**dataclasses.asdict(jcfg)).replace(
        results_dir=os.path.join(str(tmp_path), "torch"))
    tr = ttrain.Trainer(tcfg, device="cpu")
    full = tr._full_state(include_replay=True)
    agent = st["agent"]  # its PRNG keys have no counterpart in the port
    opt = opt_state_from_jax(jax.tree.map(np.asarray, agent.opt_state),
                             device="cpu")
    full["agent"].update(
        params=params_from_jax(agent.params, device="cpu"),
        target_params=params_from_jax(agent.target_params, device="cpu"),
        opt_state={"mu": opt.mu, "nu": opt.nu, "count": opt.count},
        step=int(agent.step))
    full["replay"] = dataclasses.asdict(replay_from_jax(
        jax.tree.map(np.asarray, st["replay"]), device="cpu"))
    full["T"], full["metrics_json"] = int(st["T"]), np.asarray(
        st["metrics_json"])
    port_path = os.path.join(str(tmp_path), "imported.npz")
    ckpt.save_state(port_path, full, compress=True)

    tr.restore_checkpoint(port_path)
    back = params_to_jax(tr.agent.params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtr.agent.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(tr.agent.opt_state.count) == int(
        np.asarray(jtr.agent.opt_state[1][0].count))
    for f in dataclasses.fields(tr.rep):
        np.testing.assert_array_equal(getattr(tr.rep, f.name).numpy(),
                                      np.asarray(getattr(jtr.rep, f.name)),
                                      err_msg=f.name)
    assert tr.T == jtr.T and tr.metrics == jtr.metrics

    rng = np.random.default_rng(0)
    states = rng.integers(0, 256, (16, 84, 84, 4)).astype(np.uint8)
    want = np.asarray(jag.act(jtr.agent.params, jcfg, jtr.action_space,
                              jto_network_input(jnp.asarray(states)), None))
    x = to_network_input(torch.from_numpy(states))
    head = forward_head(tr.agent.params, tcfg, tr.action_space, x)
    assert torch.equal(tag.act(tr.agent.params, tcfg, tr.action_space, x),
                       head.action)
    # Greedy actions agree wherever the top-2 gap of q is clear of float32
    # rounding in another summation order.
    top2 = head.q.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] > 1e-5).numpy()
    assert clear.sum() >= 12
    np.testing.assert_array_equal(head.action.numpy()[clear], want[clear])
