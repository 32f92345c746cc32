"""The kernel wrappers' contract, checked on the CPU (the kernels themselves
run only on the card, where tests/test_torch_port_cuda.py holds each
against its plain version): a wrapper takes CUDA tensors only and never falls back, the
dispatchers take the plain versions for CPU tensors without launching, the
launch counters, the build's naming, chip_smoke.py's refusal to run
without a card or without the package beside it, and the bf16 launch plan
of the noisy-linear tensor-core kernels."""
import math
import os
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from rainbow_tpu_torch import kernels
from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.kernels import build
from rainbow_tpu_torch.kernels import c51 as k4
from rainbow_tpu_torch.kernels.adam import clip_adam
from rainbow_tpu_torch.kernels.append_framestack import append_framestack
from rainbow_tpu_torch.kernels import dueling_head as kb
from rainbow_tpu_torch.kernels.dueling_head import dueling_head_fwd
from rainbow_tpu_torch.kernels import noise as k2
from rainbow_tpu_torch.kernels.noisy_linear import (FWD_TILES, KT, WAVE,
                                                    bwd_plan, fwd_plan,
                                                    noisy_linear_bwd,
                                                    noisy_linear_fwd)
from rainbow_tpu_torch.models.noisy import init_noisy_params, noisy_linear
from rainbow_tpu_torch.ops.c51 import c51_target, head_loss, support_vector
from rainbow_tpu_torch.ops.head import dueling_head
from rainbow_tpu_torch.ops.preprocess import update_framestack

ROOT = Path(__file__).resolve().parents[1]


def _layer():
    return init_noisy_params(torch.Generator().manual_seed(0), 8, 4, 0.5)


@pytest.mark.parametrize("call", [
    lambda: noisy_linear_fwd(_layer(), torch.zeros(2, 8)),
    lambda: dueling_head_fwd(torch.zeros(2, 51), torch.zeros(2, 102),
                             support_vector(-10, 10, 51, "cpu"), 2),
    lambda: append_framestack(torch.zeros(2, 84, 84, 4, dtype=torch.uint8),
                              torch.zeros(2, 84, 84, dtype=torch.uint8),
                              torch.zeros(0, 84, 84, dtype=torch.uint8),
                              torch.zeros(0, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.uint8)),
    lambda: noisy_linear_bwd(_layer()["weight_mu"], _layer()["weight_sigma"],
                             torch.zeros(2, 8), torch.zeros(2, 4)),
    lambda: k4.c51_target(torch.zeros(2, 3, 51), torch.zeros(2).long(),
                          torch.zeros(2), torch.zeros(2),
                          0.97, support_vector(-10, 10, 51, "cpu"), -10, 10),
    lambda: k4.head_loss(torch.zeros(2, 51), torch.zeros(2, 153),
                         torch.zeros(2).long(), torch.zeros(2, 51),
                         torch.ones(2)),
    lambda: clip_adam([torch.zeros(3)], [torch.zeros(3)], [torch.zeros(3)],
                      [torch.zeros(3)], torch.zeros((), dtype=torch.int32),
                      1e-3, 0.9, 0.999, 1e-8, 10.0),
    lambda: k2.scaled_noise(0, 0, [(5,), (3, 2)], "cpu"),
    lambda: k2.box_muller(torch.zeros(4, dtype=torch.int64)),
    lambda: k4.c51_target(torch.zeros(2, 3, 51), torch.zeros(2).int(),
                          torch.zeros(2), torch.ones(2), 0.97,
                          support_vector(-10, 10, 51, "cpu"), -10, 10),
], ids=["noisy_linear_fwd", "dueling_head", "append_framestack",
        "noisy_linear_bwd", "c51_target", "c51_loss", "clip_adam",
        "scaled_noise", "box_muller", "c51_target_int32"])
def test_wrappers_refuse_cpu_tensors(call):
    before = kernels.launches()
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert kernels.launches() == before


def test_dispatchers_run_plain_versions_on_cpu_without_launching():
    kernels.reset_launches()
    x = torch.ones(3, 8, requires_grad=True)
    y = noisy_linear(_layer(), x, relu=True)
    y.sum().backward()
    z = support_vector(-10, 10, 51, "cpu")
    out = dueling_head(torch.zeros(3, 51), torch.zeros(3, 102), z, 2, "probs")
    m = c51_target(out.dist, out.action, torch.zeros(3), torch.ones(3), 0.97,
                   z, -10.0, 10.0)
    v = torch.zeros(3, 51, requires_grad=True)
    losses, loss = head_loss(v, torch.zeros(3, 102), out.action, m,
                             torch.ones(3))
    loss.backward()
    p = [torch.ones(3)]
    ag.apply_grads_plain(p, [torch.ones(3)], [torch.zeros(3)],
                         [torch.zeros(3)], torch.zeros((), dtype=torch.int32),
                         1e-3, 0.9, 0.999, 1e-8, 10.0)
    st = torch.zeros(2, 84, 84, 4, dtype=torch.uint8)
    new = update_framestack(st, st[..., 0] + 1, st[..., 0],
                            torch.zeros(2, dtype=torch.uint8))
    assert y.shape == (3, 4) and float(y.detach().min()) >= 0.0
    assert x.grad.shape == (3, 8) and v.grad.shape == (3, 51)
    assert out.dist.shape == (3, 2, 51)
    assert m.shape == (3, 51) and losses.shape == (3,)
    assert float(p[0][0]) < 1.0
    assert int(new[..., -1].min()) == 1
    assert kernels.launches() == dict.fromkeys(kernels.LAUNCHES, 0)


def _head_call(name, atoms, n_act=2, dtype=torch.float32, dist=None):
    v, a = torch.zeros(2, atoms, dtype=dtype), torch.zeros(2, n_act * atoms,
                                                         dtype=dtype)
    if name == "dueling_head":
        return dueling_head_fwd(v, a, support_vector(-10, 10, atoms, "cpu"),
                                n_act, dist)
    if name == "c51_target":
        return k4.c51_target(a.view(2, n_act, atoms), torch.zeros(2).long(),
                             torch.zeros(2), torch.ones(2), 0.97,
                             support_vector(-10, 10, atoms, "cpu"), -10, 10)
    return k4.head_loss(v, a, torch.zeros(2).long(), torch.zeros(2, atoms),
                        torch.ones(2))


@pytest.mark.parametrize("name", ["dueling_head", "head_loss", "c51_target"])
def test_head_wrappers_refuse_cpu_tensors_and_too_many_atoms(name):
    """The kernels of csrc/head.cu take at most MAX_ATOMS atoms (each lane
    of a row's warp holds at most 4): the wrappers raise above it before
    anything else, on CPU tensors at any width, and launch nothing."""
    before = kernels.launches()
    for atoms in (21, 51, kb.MAX_ATOMS):
        with pytest.raises(ValueError, match="CUDA"):
            _head_call(name, atoms)
    for atoms in (kb.MAX_ATOMS + 1, 0):
        with pytest.raises(ValueError, match="atoms"):
            _head_call(name, atoms)
    assert kernels.launches() == before


def test_dueling_head_wrapper_refuses_an_unknown_mode():
    before = kernels.launches()
    with pytest.raises(ValueError, match="dist"):
        _head_call("dueling_head", 51, dist="logits")
    assert kernels.launches() == before


def test_head_source_exports_what_the_wrappers_bind(monkeypatch):
    """build.SOURCES names csrc/head.cu, which exports each C function the
    three wrappers bind, with as many parameters as the wrappers declare."""
    assert "head" in build.SOURCES
    src = (ROOT / "rainbow_tpu_torch/kernels/csrc/head.cu").read_text()
    bound = {}

    class Lib:
        def __getattr__(self, fn):
            bound[fn] = types.SimpleNamespace()
            return bound[fn]

    monkeypatch.setattr(build, "load", lambda name: Lib())
    kb._lib.__wrapped__()
    k4._target_lib.__wrapped__()
    k4._loss_lib.__wrapped__()
    assert set(bound) == {"dueling_head", "c51_target", "head_loss"}
    for fn, ns in bound.items():
        sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert sig, fn
        assert len(sig.group(1).split(",")) == len(ns.argtypes), fn
        assert ns.restype is not None


def test_noise_source_exports_what_the_wrapper_binds(monkeypatch):
    """csrc/noise.cu exports the draw and the Box–Muller entry with as many
    parameters as kernels/noise.py declares."""
    src = (ROOT / "rainbow_tpu_torch/kernels/csrc/noise.cu").read_text()
    lib = types.SimpleNamespace(scaled_noise=types.SimpleNamespace(),
                                noise_box_muller=types.SimpleNamespace())
    monkeypatch.setattr(build, "load", lambda name: lib)
    k2._lib.__wrapped__()
    for fn in ("scaled_noise", "noise_box_muller"):
        sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert sig, fn
        ns = getattr(lib, fn)
        assert len(sig.group(1).split(",")) == len(ns.argtypes), fn
        assert ns.restype is not None


def test_replay_and_append_sources_export_what_the_wrappers_bind(
        monkeypatch):
    """csrc/append_framestack.cu and csrc/replay.cu export each C function
    that kernels/append_framestack.py and kernels/replay.py bind, with as
    many parameters as the wrappers declare."""
    from rainbow_tpu_torch.kernels import append_framestack as kc
    from rainbow_tpu_torch.kernels import replay as k_replay

    for source, wrapper, fns in (
            ("append_framestack", kc, ("append_framestack",)),
            ("replay", k_replay, ("stratified_sample", "gather_window",
                                  "write_priorities"))):
        src = (ROOT / f"rainbow_tpu_torch/kernels/csrc/{source}.cu").read_text()
        lib = types.SimpleNamespace(**{fn: types.SimpleNamespace()
                                       for fn in fns})
        monkeypatch.setattr(build, "load", lambda name: lib)
        wrapper._lib.__wrapped__()
        for fn in fns:
            sig = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert sig, fn
            ns = getattr(lib, fn)
            assert len(sig.group(1).split(",")) == len(ns.argtypes), fn
            assert ns.restype is not None


def test_delta_source_exports_what_the_wrapper_binds(monkeypatch):
    """csrc/delta.cu exports apply_delta with as many parameters as
    kernels/delta.py declares, the env offsets among them (not counts)."""
    from rainbow_tpu_torch.kernels import delta as k10

    src = (ROOT / "rainbow_tpu_torch/kernels/csrc/delta.cu").read_text()
    lib = types.SimpleNamespace(apply_delta=types.SimpleNamespace())
    monkeypatch.setattr(build, "load", lambda name: lib)
    k10._lib.__wrapped__()
    sig = re.search(r'extern "C" int apply_delta\(([^)]*)\)', src)
    assert sig and "offsets" in sig.group(1)
    assert len(sig.group(1).split(",")) == len(lib.apply_delta.argtypes)
    assert lib.apply_delta.restype is not None


_IMPORTS = re.compile(r"^\s*(import|from)\s+(triton|jax|rainbow_tpu)\b",
                      re.M)


def test_port_imports_no_triton_jax_or_reference():
    """No module of the port, and not chip_smoke.py, imports triton, jax or
    the JAX package, at the top or inside a function; and every module of
    the port imports in an interpreter where those three cannot be
    imported."""
    files = sorted((ROOT / "rainbow_tpu_torch").rglob("*.py"))
    for path in files + [ROOT / "chip_smoke.py"]:
        assert not _IMPORTS.search(path.read_text()), path
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('triton', 'jax', 'rainbow_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import rainbow_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    rainbow_tpu_torch.__path__, 'rainbow_tpu_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(len(mods))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= len(files) - 1


def test_build_names_libraries_by_source_hash():
    assert set(build.SOURCES) == {"noisy_linear", "append_framestack", "adam",
                                  "replay", "noise", "delta", "head"}
    for name in build.SOURCES:
        path = build.lib_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (ROOT / "rainbow_tpu_torch/kernels/csrc" / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_to_run_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert res.stdout == ""  # no result line of any kind


def test_chip_smoke_refuses_to_run_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# The bf16 plan of the noisy-linear kernels (tensor cores) at one row,
# evaluation's 10, the learner's 32, the validation chunks' 250, the
# throughput preset's learner's 256, the actor's 1024 and the round's 8192
# target rows; on fc_h, both fc_z of pong, the data-efficient net's fc_h
# and a layer ragged against every tile edge.
BF16_LAYERS = [(3136, 512), (512, 51), (512, 306), (576, 256), (3137, 513)]
# fc_h's (path, tile, chunk, splits) at each batch: the small path until
# its 64-output tiles fill a wave, split-K to fill one; no chunk is capped,
# since the small path streams x through its ring too (float32 caps them
# at CHUNK_MAX = 256: 13 chunks at B = 250).
BF16_FC_H = {1: ("small", 16, 192, 17), 10: ("small", 16, 192, 17),
             32: ("small", 32, 192, 17), 250: ("small", 32, 1056, 3),
             256: ("small", 32, 1056, 3), 1024: ("large", 128, 784, 4),
             8192: ("large", 128, 3136, 1)}


def _k16_chunks(chunks, n, splits):
    """The chunks cover [0, n) once, in order, none empty, all but the last
    a whole number of the MMA's k (16)."""
    assert len(chunks) == splits
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(e > s for s, e in chunks)
    assert all((e - s) % 16 == 0 for s, e in chunks[:-1])


@pytest.mark.parametrize("b", sorted(BF16_FC_H))
def test_bf16_noisy_linear_plan(b):
    """Path and tile as intended, tiles covering ragged B and OUT, chunks of
    whole k16 steps covering IN (forward) and OUT (backward's dx), blocks
    and the partials' scratch (one plane per accumulator and chunk) from
    them."""
    assert KT == 16
    path, tile, chunk, splits = BF16_FC_H[b]
    plan = fwd_plan(b, 3136, 512, 1, torch.bfloat16)
    assert (plan.path, plan.tile, plan.chunk, plan.splits) == (
        path, tile, chunk, splits)
    for n_in, n_out in BF16_LAYERS:
        for mode in (0, 1, 2):
            planes = 2 if mode else 1
            plan = fwd_plan(b, n_in, n_out, mode, torch.bfloat16)
            rows, cols = FWD_TILES[plan.tile]
            small = (math.ceil(b / (16 if b <= 16 else 32))
                     * math.ceil(n_out / 64) < WAVE)
            assert plan.path == ("small" if small else "large")
            assert plan.tile == (128 if not small else 16 if b <= 16 else 32)
            assert (rows, cols) == ((plan.tile, 64) if small else (128, 128))
            grid = (math.ceil(b / rows), math.ceil(n_out / cols))
            assert (grid[0] - 1) * rows < b <= grid[0] * rows
            assert (grid[1] - 1) * cols < n_out <= grid[1] * cols
            assert plan.blocks == grid[0] * grid[1] * plan.splits
            _k16_chunks(plan.chunks(n_in), n_in, plan.splits)
            assert plan.scratch == (planes * plan.splits * b * n_out
                                    if plan.splits > 1 else 0)
            if plan.path == "large":  # whole waves: a block an SM
                assert plan.blocks <= WAVE or plan.splits == 1
            bwd = bwd_plan(b, n_in, n_out, mode, torch.bfloat16)
            assert bwd.path == "small"
            _k16_chunks(bwd.chunks(n_out), n_out, bwd.splits)
            assert bwd.scratch == (planes * bwd.splits * b * n_in
                                   if bwd.splits > 1 else 0)
