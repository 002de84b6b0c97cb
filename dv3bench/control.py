# coding: utf-8
"""Readings that set a cell's output limits (not run by the benchmark's
own runs): for each seed, the program's numbers through the cell's timed
path with a short window, and the control's, the reference one precision
below the configuration's in the program's place, on the same calls; with
--fault, the numbers with that fault of faults.py planted instead.

    python3 dv3bench/control.py --workload <cell> --seconds <s> \
        --seeds <n>[,<n>...] [--fault <name>] [--out <file.json>]

One process reads every seed. Needs a CUDA device."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dv3bench import bench  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out")
    p.add_argument("--fault", help="plant a fault of faults.py under the "
                   "timed path (its readings, not the control's)")
    args = p.parse_args(argv)
    bench.setup_environment()
    cell, hp, traffic, limits = bench.cell_files(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    bench.tf32_off(torch)
    import importlib
    kind = importlib.import_module("dv3bench.kinds." + traffic["kind"])
    kw = {"control": args.fault is None}
    if args.fault:
        from dv3bench import faults
        key, table = faults.BY_KIND[traffic["kind"]]
        kw[key] = table[args.fault]
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = kind.run(hp, traffic, seed, args.seconds, 0, "cuda",
                         lambda: None, **kw)
        row = {"seed": seed, "fault": args.fault, "program": out["numbers"],
               "control": out.get("control_numbers"),
               "notes": out.get("notes"),
               "metrics": out.get("metrics"), "s": time.time() - t0}
        print(json.dumps(row, default=str), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
