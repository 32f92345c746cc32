"""Run one cell of the port's benchmark once and print its result.

    python3 port_bench/run.py --workload canonical-b1024 --seed 7 \
        --seconds 20 --trace 0

From the root of a checkout, on a machine with the chips the cell asks
for. The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; ``checks`` last, each number compared with its
limit, which also end standard error. Without a CUDA device, with fewer
than the cell asks for, or with JAX or the JAX package loaded once the
window has closed, it prints no result and exits with 2, 3 or 4.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Caches of the program's kernels stay in the checkout, at fixed paths.
    cache = os.path.join(ROOT, "port_bench", ".cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))

    import torch

    from port_bench.harness import cell, manifest

    w = {c["name"]: c for c in manifest.load_manifest()["workloads"]}
    if args.workload not in w:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(w[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), device="cuda",
                        started=cell.process_start())
    bad = cell.forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 4
    res = out["result"]
    w = out["window"]
    print("window " + json.dumps({k: w[k] for k in (
        "iterations", "seconds", "setup_s", "timer")}), file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
