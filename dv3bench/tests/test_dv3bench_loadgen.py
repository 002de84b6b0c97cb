# coding: utf-8
"""The open-loop load generator and the knee sweep's arithmetic, against a
stub of the port's /tts endpoint on 127.0.0.1 (chunked WAV: a 44-byte
header chunk, then PCM chunks)."""

import statistics
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from dv3bench import knee, loadgen

TEXTS = [("a short one.", None), ("and another one, longer.", None)]


class _Stub(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    delay_s = 0.05
    shed = False

    def log_message(self, *a):
        pass

    def do_GET(self):
        if self.shed:
            self.send_response(503)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        for data in (b"\0" * 44, b"\1" * 200, b"\2" * 300):
            time.sleep(self.delay_s)
            self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
        self.wfile.write(b"0\r\n\r\n")


@pytest.fixture
def stub():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def test_schedule_same_gaps_for_every_seed():
    a = knee.schedule(5.0, 20.0, TEXTS, 3_000_000_001)
    b = knee.schedule(5.0, 20.0, TEXTS, 3_000_000_001)
    c = knee.schedule(5.0, 20.0, TEXTS, 17)
    assert a == b and len(a) == 100 and a[0][0] == 0.0
    gaps = lambda s: sorted(np.diff([d for d, _, _ in s]).round(9))
    assert a != c
    # the same set of gaps but one (the first, which is not waited), in
    # another order; the same mean rate
    assert abs(np.mean(gaps(a)) - 0.2) < 0.02
    assert abs(a[-1][0] - c[-1][0]) < 1.0


def test_every_response_read_to_its_end(stub):
    port = stub.server_address[1]
    sched = knee.schedule(40.0, 0.25, TEXTS, 5)
    t0 = time.time() + 0.1
    recs = loadgen.run(port, t0, sched)
    assert len(recs) == len(sched) == 10
    for r, (d, _, _) in zip(recs, sched):
        assert r["status"] == 200 and r["pcm_bytes"] == 500
        assert r["due"] == pytest.approx(t0 + d)
        assert r["sent"] >= r["due"] - 0.01       # sent when due, not early
        assert r["due"] < r["first_pcm"] <= r["end"]
        # the first PCM bytes come after the header chunk's delay
        assert r["first_pcm"] - r["sent"] >= 2 * _Stub.delay_s * 0.9


def test_shed_requests_count_as_missing(stub, monkeypatch):
    monkeypatch.setattr(_Stub, "shed", True)
    recs = loadgen.run(stub.server_address[1], time.time(),
                       knee.schedule(20.0, 0.2, TEXTS, 5))
    t = {"emit_dispatch": 0.0, "admit": 0.0, "n_steps": 0}
    s = knee.summary(20.0, 0.2, recs, [(0.0, 0, 0), (0.1, 0, 0)],
                     recs[0]["due"], 22050, t, t)
    assert s["shed"] == 4 and s["ok"] == 0
    assert s["ttfa_p95_ms"] == float("inf")
    assert not knee.sustained(s)


def test_percentile_of_late_and_missing_requests():
    xs = [float(i) for i in range(1, 20)]
    for q in (0.5, 0.95):
        assert knee.pct(xs, q) == pytest.approx(
            statistics.quantiles(xs, n=100, method="inclusive")[
                int(q * 100) - 1])
    assert knee.pct([None] * 4, 0.5) == float("inf")
    assert knee.pct([1.0, None], 0.5) == float("inf")
    assert knee.pct([1.0, 2.0, None], 0.5) == 2.0


def test_summary_and_knee_rule():
    t0 = 1000.0
    recs = [{"due": t0 + i, "sent": t0 + i, "status": 200,
             "first_pcm": t0 + i + 0.1 * (i + 1), "end": t0 + i + 1.0,
             "pcm_bytes": 2 * 22050} for i in range(10)]
    growing = [(t / 4.0, int(t), 8) for t in range(40)]
    flat = [(t / 4.0, 1, 8) for t in range(40)]
    t0_ = {"emit_dispatch": 10.0, "admit": 5.0, "n_steps": 10}
    t1_ = {"emit_dispatch": 40.0, "admit": 15.0, "n_steps": 20}
    s = knee.summary(1.0, 10.0, recs, flat, t0, 22050, t0_, t1_)
    assert s["ok"] == 10 and s["shed"] == 0
    assert s["audio_s_per_s"] == pytest.approx(1.0)
    assert s["ttfa_p50_ms"] == pytest.approx(550.0)
    assert s["step_ms"] == pytest.approx(4.0)
    assert s["emit_dispatch_share"] == pytest.approx(0.75)
    assert knee.sustained(s)
    s = knee.summary(1.0, 10.0, recs, growing, t0, 22050, t0_, t1_)
    assert not knee.sustained(s)
    # one request stalled by 2 s moves the tail over all requests, not the
    # median
    stalled = [dict(r) for r in recs]
    stalled[3]["first_pcm"] += 2.0
    s2 = knee.summary(1.0, 10.0, stalled, flat, t0, 22050, t0_, t1_)
    assert s2["ttfa_p95_ms"] > s["ttfa_p95_ms"] + 500
    assert s2["ttfa_p50_ms"] == pytest.approx(s["ttfa_p50_ms"], abs=101)


def test_segment_reads_the_queue_until_the_load_ends(stub):
    class Batcher:
        def waiting(self):
            return 2

        def active_slots(self):
            return 1

    class Engine:
        batcher = Batcher()

    recs, samples, t0 = knee.segment(
        Engine(), stub.server_address[1],
        knee.schedule(10.0, 0.3, TEXTS, 9), sample_s=0.05)
    assert len(recs) == 3 and all(r["status"] == 200 for r in recs)
    assert samples and all(w == 2 for _, w, _ in samples)
    assert max(r["end"] for r in recs) <= t0 + samples[-1][0] + 0.1
