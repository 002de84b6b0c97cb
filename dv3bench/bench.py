# coding: utf-8
"""What every cell's run shares: the command line, the cell's files found
by name from BENCHMARK.json, the environment (build and kernel caches
inside the checkout, TF32 off), the card, the profiler's reading, the
guard against JAX, and the result line."""

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deepvoice3_pytorch_tpu")


def process_start():
    """Wall time (time.time()) at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark "
                                "once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name, bench=None):
    """(workload entry, configuration dict, traffic dict, limits dict) of a
    cell, each found by name."""
    bench = bench or benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (cell, load_json(ROOT / conf["file"]),
            load_json(HERE / "traffic" / (cell["traffic"] + ".json")),
            limits(name))


def limits(name):
    """The output limits of cell `name` (limits/<name>.json)."""
    return load_json(HERE / "limits" / (name + ".json"))


def cell_metrics(name, bench=None, which="end_to_end"):
    """The metric entries of BENCHMARK.json that this cell reports."""
    bench = bench or benchmark()
    return [m for m in bench[which]
            if "workloads" not in m or name in m["workloads"]]


def limit_threads(n=2):
    """Few host threads for the process's intra-op pools (set before torch
    is imported): the one-chip machine shares its cores with its host."""
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(k, str(n))


def setup_environment():
    """Build and kernel caches at fixed paths inside the checkout; TF32 off
    (the configurations state float32)."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def tf32_off(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card(torch, n):
    """The device block of the result line, and the card's power limit."""
    import subprocess
    limit = None
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n}, limit


def forbidden_modules():
    """Modules loaded in this process whose top-level name (the part
    before the first dot) is JAX's, jaxlib's, flax's or the JAX package's,
    compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_metric(name):
    """The reader of per-layer metric `name`: metrics/<name>.py's read."""
    path = HERE / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "dv3bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers, limits):
    """(correct, [(name, number, limit)]): every number at or under its
    limit; a number with no limit, or a limit with no number, fails."""
    rows = [(k, numbers.get(k), limits[k]) for k in sorted(limits)]
    rows += [(k, v, None) for k, v in sorted(numbers.items())
             if k not in limits]
    ok = all(n is not None and lim is not None and isinstance(n, (int, float))
             and math.isfinite(n) and n <= lim for _, n, lim in rows)
    return ok, rows


def emit(result, rows):
    """The compared numbers beside their limits as the last lines on
    standard error, and the result line (with them under `checked`, last)
    as the last line on standard output."""
    for k, n, lim in rows:
        print("check %s %r limit %r" % (k, n, lim), file=sys.stderr)
    result["checked"] = {k: {"value": n, "limit": lim} for k, n, lim in rows}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
