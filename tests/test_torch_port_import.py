"""The port's model import (rainbow_tpu_torch.utils.torch_import) against
the JAX package's (rainbow_tpu/utils/torch_import.py), on the CPU: a
synthetic reference state dict saved with torch.save in tmp_path (nothing is
downloaded), and the JAX package's own ``model.npz`` read without JAX.

Both conversions copy float32 values (transposes only), so they are held
bit for bit; the μ-only forward of the imported params agrees with JAX's to
1e-5 (float32 in another order).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rainbow_tpu
from rainbow_tpu import checkpoint as jckpt
from rainbow_tpu.models import dqn as jdqn
from rainbow_tpu.utils import torch_import as jtim

import rainbow_tpu_torch
from rainbow_tpu_torch import checkpoint as tckpt
from rainbow_tpu_torch import cli as tcli
from rainbow_tpu_torch.convert import params_from_jax
from rainbow_tpu_torch.models.dqn import forward_head
from rainbow_tpu_torch.utils import torch_import as tim

from test_torch_import import make_reference_state_dict

A, HIDDEN = 4, 32  # the fake env's action space
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LEGACY = {"convs.0": "conv1", "convs.2": "conv2", "convs.4": "conv3"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: several test workers share the cores, and these
    tests' small ops slow down under thread contention; the results do not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state_dict(arch, legacy=False, seed=0):
    """A reference state dict with its noise buffers, optionally under the
    pre-refactor conv names."""
    rng = np.random.default_rng(seed)
    sd, _, _ = make_reference_state_dict(rng, arch, HIDDEN, A)
    for name in ("fc_h_v", "fc_h_a", "fc_z_v", "fc_z_a"):
        sd[f"{name}.weight_epsilon"] = torch.randn_like(sd[f"{name}"
                                                           ".weight_mu"])
        sd[f"{name}.bias_epsilon"] = torch.randn_like(sd[f"{name}.bias_mu"])
    if legacy:
        sd = {(_LEGACY[k.rsplit(".", 1)[0]] + "." + k.rsplit(".", 1)[1]
               if k.rsplit(".", 1)[0] in _LEGACY else k): v
              for k, v in sd.items()}
    return sd


def _cfgs(arch):
    kw = dict(architecture=arch, hidden_size=HIDDEN)
    return rainbow_tpu.canonical(**kw), rainbow_tpu_torch.canonical(**kw)


@pytest.mark.parametrize("arch,legacy", [("canonical", False),
                                         ("data-efficient", False),
                                         ("canonical", True)],
                         ids=["canonical", "data-efficient", "legacy"])
def test_import_matches_jax_bit_for_bit(arch, legacy, tmp_path, capsys):
    """``python -m rainbow_tpu_torch.utils.torch_import model.pth
    model.npz`` writes the params that JAX's convert_state_dict then
    params_from_jax give, with the noise buffers dropped."""
    sd = _state_dict(arch, legacy)
    pth, out = str(tmp_path / "model.pth"), str(tmp_path / "model.npz")
    torch.save(sd, pth)
    tim.main([pth, out])
    got = tckpt.load_params(out, "cpu")
    want = params_from_jax(jtim.convert_state_dict(
        torch.load(pth, weights_only=True)), "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    n = sum(v.numel() for v in want.values())
    assert capsys.readouterr().out.strip().endswith(f"({n:,} params)")


@pytest.mark.parametrize("arch", ["canonical", "data-efficient"])
def test_imported_model_forward_matches_jax(arch):
    """The μ-only forward (the evaluation path) of the imported params
    against JAX's apply_dqn on JAX's conversion of the same state dict."""
    jcfg, tcfg = _cfgs(arch)
    sd = _state_dict(arch, seed=1)
    x = np.random.default_rng(2).random((3, 84, 84, 4)).astype(np.float32)
    want = jdqn.apply_dqn(jtim.convert_state_dict(sd), jcfg, A,
                          jnp.asarray(x), None)
    got = forward_head(tim.convert_state_dict(sd), tcfg, A,
                       torch.from_numpy(x), dist="probs").dist
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_convert_state_dict_refuses_what_is_not_a_dqn():
    sd = _state_dict("data-efficient")
    with pytest.raises(ValueError, match="unexpected .*extra"):
        tim.convert_state_dict({**sd, "extra.weight": torch.zeros(1)})
    del sd["fc_z_a.bias_sigma"]
    with pytest.raises(ValueError, match="missing .*fc_z_a.bias_sigma"):
        tim.convert_state_dict(sd)


def _jax_params(arch, bf16_leaf=True, seed=0):
    jcfg, _ = _cfgs(arch)
    params = jdqn.init_dqn_params(jax.random.key(seed), jcfg, A)
    if bf16_leaf:  # a bfloat16 leaf, stored as its uint16 bits
        params["fc_z_a"]["w_sigma"] = params["fc_z_a"]["w_sigma"].astype(
            jnp.bfloat16)
    return params


@pytest.mark.parametrize("arch", ["canonical", "data-efficient"])
def test_jax_model_npz_reads_without_jax(arch, tmp_path):
    """A model.npz written by the JAX package's save_params, read by
    load_jax_params bit for bit as params_from_jax converts the params,
    the bfloat16 leaf included; then again in a process where importing JAX
    fails."""
    path = str(tmp_path / "model.npz")
    params = _jax_params(arch)
    jckpt.save_params(path, params)
    assert tim.is_jax_checkpoint(path)
    _, tcfg = _cfgs(arch)
    got = tim.load_jax_params(path, tcfg, A, "cpu")
    want = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    out = str(tmp_path / "again.npz")
    code = ("import sys; sys.modules['jax'] = None\n"
            "import rainbow_tpu_torch as r, torch\n"
            "from rainbow_tpu_torch.utils import torch_import as tim\n"
            "from rainbow_tpu_torch import checkpoint as ck\n"
            f"cfg = r.canonical(architecture={arch!r}, hidden_size={HIDDEN})\n"
            f"ck.save_params({out!r}, tim.load_jax_params({path!r}, cfg, {A},"
            " 'cpu'))\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    again = tckpt.load_params(out, "cpu")
    for k, v in want.items():
        assert torch.equal(again[k], v), k


def test_jax_model_npz_that_does_not_fit_raises(tmp_path):
    """Never a guess: another architecture, another action space, a file of
    another kind."""
    path = str(tmp_path / "model.npz")
    jckpt.save_params(path, _jax_params("canonical", bf16_leaf=False))
    _, canonical = _cfgs("canonical")
    _, efficient = _cfgs("data-efficient")
    with pytest.raises(ValueError, match="leaves"):
        tim.load_jax_params(path, efficient, A, "cpu")
    with pytest.raises(ValueError, match="arr_14 .*fc_z_a.bias_mu"):
        tim.load_jax_params(path, canonical, A + 1, "cpu")
    state = str(tmp_path / "state.npz")
    jckpt.save_pytree(state, {"k": jax.random.key(0), **{
        f"x{i:02d}": np.zeros(1) for i in range(21)}})
    with pytest.raises(ValueError, match="not a params file"):
        tim.load_jax_params(state, canonical, A, "cpu")


@pytest.mark.parametrize("source", ["pth", "jax"])
def test_imported_model_loads_through_cli(source, tmp_path, monkeypatch):
    """``cli --evaluate --model`` takes the converted model.npz, and a
    JAX-written one as it is; the Trainer's params are the file's."""
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "model.npz")
    if source == "pth":
        torch.save(_state_dict("data-efficient", seed=3),
                   str(tmp_path / "model.pth"))
        want = tim.import_torch_model(str(tmp_path / "model.pth"), out)
    else:
        params = _jax_params("data-efficient")
        jckpt.save_params(out, params)
        want = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tr = tcli.main(["--num-envs", "4", "--memory-capacity", "1024",
                    "--evaluation-episodes", "1", "--evaluation-size", "8",
                    "--hidden-size", str(HIDDEN), "--env-backend", "fake",
                    "--max-episode-length", "60", "--architecture",
                    "data-efficient", "--evaluate", "--model", out],
                   device="cpu")
    for k, v in want.items():
        assert torch.equal(tr.agent.params[k], v), k
        assert torch.equal(tr.agent.target_params[k], v), k
