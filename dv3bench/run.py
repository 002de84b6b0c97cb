# coding: utf-8
"""Run one cell of the benchmark once:

    python3 dv3bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic and output limits are found by name from
BENCHMARK.json; the traffic file's `kind` names its loop
(kinds/<kind>.py). With --trace 0 the result line carries the cell's
end-to-end metrics, with --trace 1 its per-layer metrics, read by
metrics/<name>.py from a profiled window. Needs as many CUDA devices as the
cell asks for: without them it exits non-zero and prints no result."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dv3bench import bench  # noqa: E402

bench.limit_threads()
T_PROCESS = bench.process_start()


def main(argv=None):
    args = bench.parse_args(argv)
    bench.setup_environment()
    spec = bench.benchmark()
    cell, hp, traffic, limits = bench.cell_files(args.workload, spec)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print("dv3bench: the cell needs %d CUDA device(s), found %d"
              % (cell["chips"], torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    bench.tf32_off(torch)
    torch.cuda.set_device(0)
    device = "cuda"

    import importlib
    kind = importlib.import_module("dv3bench.kinds." + traffic["kind"])
    t_window = {}

    def window_started():
        t_window["t"] = time.time()

    out = kind.run(hp, traffic, args.seed, args.seconds, args.trace,
                     device, window_started)
    dev, power = bench.card(torch, cell["chips"])
    dev["memory_peak_bytes"] = out["memory_peak"]

    found = bench.forbidden_modules()
    if found:
        print("dv3bench: modules of JAX or the JAX package were loaded: %s"
              % ", ".join(found), file=sys.stderr)
        return 3

    correct, rows = bench.judge(out["numbers"], limits)
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": 0 if correct else out["attempted"]}
    if args.trace:
        ctx = out["trace"]
        tr = ctx["trace"]
        metrics = {}
        for m in bench.cell_metrics(args.workload, spec, "per_layer"):
            v = bench.load_metric(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        metrics = {}
        for m in bench.cell_metrics(args.workload, spec):
            if m["name"] == "setup_s":
                v = t_window["t"] - T_PROCESS
            else:
                v = out["metrics"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    print("dv3bench: %s seed %d, card %s; notes %s" % (
        args.workload, args.seed, power, out.get("notes")), file=sys.stderr)
    bench.emit(result, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
