"""Build the CUDA kernels from the package's sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by nvcc for sm_90a into ``rainbow_tpu_torch/_build/lib<name>-<hash>.so``,
named by a hash of its source so an edited source is never served by a
stale library. ``build_all`` starts one nvcc per source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SOURCES = ("noisy_linear", "append_framestack", "adam", "replay", "noise",
           "delta", "head")
_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    return BUILD_DIR / f"lib{name}-{hashlib.sha1(src).hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (name, process or None)."""
    out = lib_path(name)
    if out.exists():
        return name, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out_tmp, proc.out = tmp, out
    return name, proc


def _finish(name: str, proc) -> str:
    """Wait for one build; returns the compiler's output (ptxas register
    and shared-memory report). Raises if nvcc failed."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.out_tmp, proc.out)
    (BUILD_DIR / f"{name}.log").write_text(log)
    return log


def build_all() -> dict:
    """Build every kernel library, one nvcc per source started together;
    returns {name: compiler output}."""
    with _lock:
        started = [_start(n) for n in SOURCES]
        return {n: _finish(n, p) for n, p in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            _finish(*_start(name))
            _libs[name] = ctypes.CDLL(str(lib_path(name)))
        return _libs[name]
