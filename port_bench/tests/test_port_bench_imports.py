"""What the benchmark loads: never JAX or the JAX package, by whole
top-level name, and, in the reference, nothing of the program; and its
measuring path fails without a card instead of falling back to the CPU."""
import ast
import os
import subprocess
import sys

from port_bench.tests.conftest import BENCH, ROOT

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
sys.argv = ["run.py", "--workload", "canonical-b1024", "--seed", "3",
            "--seconds", "1", "--trace", "0"]
import runpy, json
from port_bench.harness import cell, manifest, settings, trace
from port_bench.reference import check, rainbow
for m in manifest.load_manifest()["per_layer"]:
    manifest.load_metric(m["name"])
for t in rainbow.TORSOS.glob("*.py"):
    rainbow.torso(t.stem)
import port_bench.readings
try:
    runpy.run_path({run!r}, run_name="__main__")
except SystemExit as e:
    code = e.code
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"code": code, "top": top}}))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _probe():
    import json
    code = PROBE.format(root=str(ROOT), run=str(BENCH / "run.py"))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_clean_env(), timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p


def test_no_jax_and_no_result_without_a_card():
    got, p = _probe()
    assert not {"jax", "jaxlib", "flax", "rainbow_tpu"} & set(got["top"])
    assert got["code"] == 3, p.stderr[-2000:]
    assert "correct" not in p.stdout


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import port_bench.reference.rainbow as r, "
            "port_bench.reference.check; "
            "torsos = sorted(t.stem for t in r.TORSOS.glob('*.py')); "
            "[r.torso(t) for t in torsos]; "
            "print(json.dumps([torsos, sorted({m.split('.')[0] for m in "
            "sys.modules})]))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_clean_env(), timeout=120)
    torsos, top = __import__("json").loads(p.stdout.strip().splitlines()[-1])
    assert {"canonical", "data-efficient"} <= set(torsos)
    assert not {"rainbow_tpu_torch", "rainbow_tpu", "jax"} & set(top)
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "rainbow_tpu_torch", "rainbow_tpu", "jax"), (path, n)


def test_the_measuring_path_needs_a_card():
    import pytest
    import torch

    from port_bench.harness import cell
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cell.run_cell("canonical-b1024", 1, 1.0, False, device="cuda")
