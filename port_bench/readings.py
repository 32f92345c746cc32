"""Readings of the numbers that decide ``correct``, for setting their
limits: for each seed, the program against the plain reference and, with
``--control``, the configuration's control (the reference in the nearest
precision below the configuration's, put in the program's place) against
the same reference, at the cell's own size, in one process. No window is
measured: each seed's run stops after its checked calls.

    python3 port_bench/readings.py --workload canonical-b1024 \
        --seeds 11 12 13 --control --out chiprun_out/readings.jsonl

The benchmark's own runs do not run the control.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_precision(config: dict):
    import torch

    from port_bench.reference.rainbow import Precision
    c = config["control"]
    return Precision(getattr(torch, c["dtype"]), c["rounding"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   help="plant one of harness/faults.py's faults")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from port_bench.harness import cell, manifest
    from port_bench.harness.faults import FAULTS
    undo = []
    if args.fault:
        def patch(obj, name, new):
            undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)
        FAULTS[args.fault](patch)
    files = manifest.resolve(manifest.load_manifest(), args.workload)
    ctrl = control_precision(files["config"]) if args.control else None
    for seed in args.seeds:
        t = time.time()
        out = cell.run_cell(args.workload, seed, None, False,
                            device=args.device, control=ctrl)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "fault": args.fault,
                           "seconds": time.time() - t, **out["readings"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    for obj, name, old in reversed(undo):
        setattr(obj, name, old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
