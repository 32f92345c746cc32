"""Where the bf16 noisy-linear forward's time goes on the card, stage by
stage: builds csrc/noisy_linear.cu with clock64() counters around the
phases of its pipeline (pipeline() in the source: the wait for the copies,
the barrier, the MMAs, the copies' issue, the conversion), runs the large
path (128 x 128 tiles, fc_h 3136 -> 512, per-row eps) at the round's 8192
rows and the actor's 1024, and prints each phase's cycles a stage (summed
over a warp's stages, averaged over warps) beside the call's CUDA-event
time. The counters cost a little time of their own.

    python3 tests/ka_stage_probe.py     # on a machine with a card and nvcc
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from rainbow_tpu_torch.kernels import build  # noqa: E402
from rainbow_tpu_torch.kernels import noisy_linear as ka  # noqa: E402
from rainbow_tpu_torch.models.noisy import (NoiseStream,  # noqa: E402
                                            init_noisy_params, scale_noise)

PHASES = ("wait", "barrier", "mma", "copies", "convert")
# (anchor in pipeline(), text put after it)
PROBES = [
    ('static_assert(NRAW >= 3, "a stage in flight beyond the next");',
     "\n  unsigned long long pc[5] = {0, 0, 0, 0, 0}, t0 = clock64(), t1;"
     "\n#define PROBE(i) t1 = clock64(); pc[i] += t1 - t0; t0 = t1;"),
    ("  convert(0);\n", "  t0 = clock64();\n"),
    ("    cp_async_wait<NRAW - 3>();\n", "    PROBE(0)\n"),
    ("                      // slot t - 1 and tile (t + 1) & 1 are free\n",
     "    PROBE(1)\n"),
    ("    compute(t);\n", "    PROBE(2)\n"),
    ("    cp_async_commit();\n    if (t + 1 < steps) convert(t + 1);\n",
     "    PROBE(4)\n"),
]
COMMIT_PROBE = "    if (t + 1 < steps) convert(t + 1);\n"
END = "  cp_async_wait<0>();\n  __syncthreads();\n}\n"
READ = """
extern "C" int probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return (int)e;
}
"""


def probed_source() -> str:
    src = open(os.path.join(ROOT, "rainbow_tpu_torch", "kernels", "csrc",
                            "noisy_linear.cu")).read()
    head = "template <int NRAW, typename Load, typename Convert"
    assert src.count(head) == 1, "pipeline() not found"
    start = src.index(head)
    end = src.index(END, start) + len(END)
    body = src[start:end]
    for anchor, text in PROBES:
        assert body.count(anchor) == 1, anchor
        body = body.replace(anchor, anchor + text)
    # the copies' phase ends at the commit, before the conversion
    body = body.replace("    cp_async_commit();\n" + COMMIT_PROBE,
                        "    cp_async_commit();\n    PROBE(3)\n" + COMMIT_PROBE)
    body = body.replace(END, (
        "  if (threadIdx.x % 32 == 0) {\n"
        "    for (int i = 0; i < 5; ++i) atomicAdd(&g_probe[i], pc[i]);\n"
        "    atomicAdd(&g_probe[5], 1ull);\n  }\n" + END))
    return (src[:start] + "__device__ unsigned long long g_probe[6];\n" + body
            + src[end:] + READ)


def main() -> int:
    if not torch.cuda.is_available():
        print("ka_stage_probe: no CUDA device", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp()
    cu, so = os.path.join(work, "probe.cu"), os.path.join(work, "probe.so")
    with open(cu, "w") as f:
        f.write(probed_source())
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if done.returncode:
        print(done.stdout + done.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    build._libs["noisy_linear"] = lib
    ka._lib.cache_clear()
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(18)
    ns = NoiseStream(18)
    prm = init_noisy_params(g, 3136, 512, 0.1)
    out = (ctypes.c_ulonglong * 6)()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi}
    for b in (8192, 1024):
        x = torch.rand((b, 3136), generator=g, device="cuda").to(
            torch.bfloat16)
        eps = (scale_noise(ns, (b, 3136), "cuda"),
               scale_noise(ns, (b, 512), "cuda"))
        plan = ka.fwd_plan(b, 3136, 512, 2, torch.bfloat16)
        ka.noisy_linear_fwd(prm, x, eps, True)
        torch.cuda.synchronize()
        assert lib.probe_read(out) == 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ka.noisy_linear_fwd(prm, x, eps, True)
        end.record()
        torch.cuda.synchronize()
        assert lib.probe_read(out) == 0
        warps, stages = out[5], plan.chunk // 16
        result[f"B={b}"] = dict(
            plan=f"{plan.path} tile {plan.tile}, {plan.splits} chunk(s) of "
                 f"{plan.chunk}", event_ms=start.elapsed_time(end),
            cycles_a_stage={n: round(out[i] / warps / stages)
                            for i, n in enumerate(PHASES)})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
