# coding: utf-8
"""Find the highest rate an HTTP serving configuration sustains (the knee):

    python3 dv3bench/knee.py --config dv3_ljspeech --traffic ljspeech_serve8 \
        --seed <n> --rates 4,8,12 --seconds 20 --out <file.json>

Builds the port's `serve.TTSServer` over `TTSEngine(slots=...)` on
127.0.0.1 with the configuration's seeded weights (the done projection held
off, so every request decodes the traffic's `max_decoder_steps`), then, for
each rate in turn, offers open-loop Poisson arrivals for `--seconds` from a
load generator in a child process (loadgen.py) and waits until the engine
is idle again. The knee is the highest rate at which no request was shed or
failed and the waiting queue did not grow over the segment. Prints one JSON
object per rate and writes them all to --out. Needs a CUDA device."""

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dv3bench import bench, generate  # noqa: E402

bench.limit_threads()


def texts_of(traffic, seed, n):
    """n (text, speaker) pairs of the traffic's corpus lengths, in an order
    drawn from the seed."""
    utts = generate.utterances(traffic, seed, n)
    order = generate.rng(seed, 8).permutation(n)
    return [(utts[i][1], utts[i][2]) for i in order]


def schedule(rate, seconds, texts, seed):
    """[(due offset s, text, speaker)]: generate.arrivals with texts, a list
    of (text, speaker), taken in turn."""
    return [(float(d), *texts[i % len(texts)])
            for i, d in enumerate(generate.arrivals(rate, seconds, seed))]


def pct(xs, q):
    """The q-quantile of xs, interpolated between order statistics as
    statistics.quantiles(method="inclusive") does; a missing entry (None)
    counts as infinitely late."""
    v = sorted(float("inf") if x is None else x for x in xs)
    if not v:
        return None
    j, frac = divmod(q * (len(v) - 1), 1.0)
    j = int(j)
    if frac == 0.0 or v[j + 1] == float("inf"):
        return v[j] if frac == 0.0 else float("inf")
    return v[j] + (v[j + 1] - v[j]) * frac


def segment(engine, port, sched, sample_s=0.25):
    """Offer one schedule; returns the records and the waiting queue's
    samples [(t since start, waiting, active)] until the engine is idle."""
    t0 = time.time() + 1.0
    child = subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("loadgen.py")),
         "--port", str(port), "--t0", repr(t0)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    out = {}

    def talk():
        out["stdout"] = child.communicate(json.dumps(sched))[0]

    th = threading.Thread(target=talk)
    th.start()
    samples = []
    b = engine.batcher
    while th.is_alive():
        samples.append((time.time() - t0, b.waiting(), b.active_slots()))
        time.sleep(sample_s)
    th.join()
    return json.loads(out["stdout"]), samples, t0


def summary(rate, seconds, recs, samples, t0, sample_rate, timing0,
            timing1):
    ok = [r for r in recs if r["status"] == 200 and r["first_pcm"]]
    shed = sum(r["status"] == 503 for r in recs)
    failed = len(recs) - len(ok) - shed
    ttfa = [1e3 * (r["first_pcm"] - r["due"]) if r in ok else None
            for r in recs]
    audio_s = sum(r["pcm_bytes"] for r in ok) / 2.0 / sample_rate
    in_win = [w for t, w, _ in samples if 0.0 <= t <= seconds]
    third = max(1, len(in_win) // 3)
    busy = {k: timing1[k] - timing0[k] for k in timing1}
    steps = busy.pop("n_steps")
    return {
        "rate": rate, "offered": len(recs), "ok": len(ok), "shed": shed,
        "failed": failed,
        "ttfa_p50_ms": pct(ttfa, 0.5), "ttfa_p95_ms": pct(ttfa, 0.95),
        "audio_s_per_s": audio_s / (max(r["end"] for r in recs) - t0),
        "waiting_first_third": statistics.mean(in_win[:third]),
        "waiting_last_third": statistics.mean(in_win[-third:]),
        "waiting_max": max(in_win),
        "drain_s": max(r["end"] for r in recs) - t0 - seconds,
        "steps": steps,
        "step_ms": sum(busy.values()) / steps if steps else None,
        "emit_dispatch_share": busy["emit_dispatch"] / sum(busy.values())
        if steps else None,
    }


def sustained(s):
    """No request shed or failed, and the waiting queue did not grow."""
    return (s["shed"] == 0 and s["failed"] == 0
            and s["waiting_last_third"] <= s["waiting_first_third"] + 1.0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    bench.setup_environment()

    import torch
    if not torch.cuda.is_available():
        print("knee: needs a CUDA device", file=sys.stderr)
        return 2
    bench.tf32_off(torch)
    from deepvoice3_pytorch_tpu_torch import serve
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en
    from dv3bench.kinds import common

    spec = bench.benchmark()
    conf = next(c for c in spec["configs"] if c["name"] == a.config)
    hp = bench.load_json(bench.ROOT / conf["file"])
    traffic = bench.load_json(bench.HERE / "traffic" / (a.traffic + ".json"))
    php, cfg_p, cfg_r = common.configs(hp)
    params = common.port_params(common.weights(
        cfg_r, a.seed, "cuda", traffic["done_bias"]))
    ap = AudioProcessor(php)
    engine = serve.TTSEngine(params, cfg_p, ap, en,
                             traffic["max_decoder_steps"],
                             slots=traffic["slots"],
                             text_pad=traffic["text_pad"])
    engine.warmup()
    server = serve.TTSServer(("127.0.0.1", 0), serve.make_handler(engine))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    texts = texts_of(traffic, a.seed, traffic["pool"])
    longest = sorted(texts, key=lambda t: -len(t[0]))
    # warm-up: the longest texts (every text bucket) at a low rate
    segment(engine, port, schedule(
        2.0, 4.0, longest[:traffic["slots"]], a.seed))

    rows = []
    for rate in [float(r) for r in a.rates.split(",")]:
        timing0 = engine.batcher.timing()
        recs, samples, t0 = segment(
            engine, port, schedule(rate, a.seconds, texts, a.seed))
        s = summary(rate, a.seconds, recs, samples, t0, ap.sample_rate,
                    timing0, engine.batcher.timing())
        s["sustained"] = sustained(s)
        print(json.dumps(s), flush=True)
        rows.append(s)
    server.shutdown()
    server.server_close()
    engine.shutdown()
    knee = max((s["rate"] for s in rows if s["sustained"]), default=None)
    with open(a.out, "w") as f:
        json.dump({"config": a.config, "traffic": a.traffic, "seed": a.seed,
                   "seconds": a.seconds, "knee": knee, "rates": rows}, f,
                  indent=1)
    print("knee: %s requests/s" % knee, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
