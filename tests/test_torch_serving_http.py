# coding: utf-8
"""The port's HTTP engine in continuous-batching mode (serve.TTSEngine(
slots=N)) on 127.0.0.1, at the narrow widths of tests/torch_port_common.py
(fft 128, hop 32): concurrent requests from one slot batch, each PCM
stream as long as the decoded length of the text's own stream; /stats with
the slot fields; a request shed by admission control as HTTP 503 with
Retry-After, counted as rejected and not as failed. Counterparts of the
HTTP tests of tests/test_serving.py."""

import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch import builder, serve, streaming
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
from deepvoice3_pytorch_tpu_torch.frontend import en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams

from torch_port_common import TINY

TEXTS = ("the first serving test sentence.", "a different second one.")
MAX = 24


@pytest.fixture(scope="module")
def tiny():
    cfg = builder.deepvoice3(**TINY)
    params = builder.model_init(cfg, torch.Generator().manual_seed(3),
                                device="cpu")
    hp = default_hparams()
    hp.fft_size, hp.hop_size = 128, 32
    return cfg, params, AudioProcessor(hp)


class _Server:
    def __init__(self, engine, server_class=ThreadingHTTPServer):
        self.engine = engine
        self.httpd = server_class(("127.0.0.1", 0),
                                  serve.make_handler(engine))
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = "http://127.0.0.1:%d" % self.httpd.server_address[1]

    def get(self, path):
        with urllib.request.urlopen(self.base + path, timeout=300) as r:
            return r.read()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.shutdown()


def test_slots_concurrent_requests_and_stats(tiny):
    cfg, params, ap = tiny
    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=MAX,
                             slots=2, text_pad=40)
    engine.warmup()
    srv = _Server(engine)
    try:
        bodies = {}

        def fetch(text):
            bodies[text] = srv.get("/tts?text=" + text.replace(" ", "%20"))

        threads = [threading.Thread(target=fetch, args=(x,)) for x in TEXTS]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert set(bodies) == set(TEXTS)
        for text, body in bodies.items():
            assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
            assert struct.unpack("<I", body[24:28])[0] == ap.sample_rate
            final = list(streaming.tts_stream(params, cfg, ap, en, [text],
                                              max_decoder_steps=MAX))[-1]
            assert len(body) - 44 == 2 * streaming.decoded_samples(
                cfg, ap, final["decoded_steps"][0])
        # a speaker_id on a single-speaker model fails at submit: HTTP 500
        with pytest.raises(urllib.error.HTTPError) as e:
            srv.get("/tts?text=x&speaker_id=3")
        assert e.value.code == 500
        s = json.loads(srv.get("/stats"))
        assert s["requests_total"] == 3          # the warm-up not counted
        assert s["requests_failed"] == 1 and s["requests_rejected"] == 0
        assert s["active_streams"] == 0 and s["audio_seconds_total"] > 0
        assert s["ttfa_ms"]["count"] == 2 and s["ttfa_ms"]["p50"] > 0
        assert s["slots"] == 2 and s["backlog"] == 0
        assert s["active_slots"] == 0
        assert s["step_phase_ms"]["n_steps"] > 0
        assert set(s["step_phase_ms"]) >= {"admit", "decode_dispatch",
                                           "emit_dispatch", "done_fetch",
                                           "complete", "retire"}
    finally:
        srv.close()


def test_slots_backlog_full_is_503_and_rejected(tiny):
    cfg, params, ap = tiny
    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=MAX,
                             slots=1, text_pad=40, max_backlog=0)
    srv = _Server(engine)
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            srv.get("/tts?text=x")
        assert e.value.code == 503
        assert e.value.headers["Retry-After"] == "1"
        assert "max_backlog" in json.loads(e.value.read())["error"]
        s = json.loads(srv.get("/stats"))
        assert s["requests_rejected"] == 1 and s["requests_failed"] == 0
        assert s["requests_total"] == 1 and s["slots"] == 1
    finally:
        srv.close()
    assert np.isfinite(s["uptime_s"])


def test_server_accept_times_end_with_their_connections(tiny):
    """serve.TTSServer keeps a connection's accept time only while the
    connection lives: a /tts request takes it into its hop trace, and
    connections that never reach a GET (a POST answered 501, a client that
    sends nothing) leave nothing behind once they close."""
    cfg, params, ap = tiny
    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=MAX,
                             slots=1, text_pad=40)
    srv = _Server(engine, serve.TTSServer)
    try:
        body = srv.get("/tts?text=" + TEXTS[0].replace(" ", "%20"))
        assert body[:4] == b"RIFF"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(
                srv.base + "/tts", data=b"x", method="POST"), timeout=60)
        assert e.value.code == 501
        port = srv.httpd.server_address[1]
        socket.create_connection(("127.0.0.1", port), timeout=60).close()
        deadline = time.time() + 30
        while srv.httpd.accept_times and time.time() < deadline:
            time.sleep(0.01)
        assert srv.httpd.accept_times == {}
        hops = engine.hops()
        assert len(hops) == 1 and hops[0]["text"] == TEXTS[0]
        h = hops[0]
        assert None not in h.values()
        # the handler thread's hops in order, and the batcher's: a slot may
        # take the request before its submit call has returned
        for chain in (("accept", "handler", "stream", "submit", "first_get",
                       "written"), ("stream", "admit", "first_put",
                                    "first_get")):
            times = [h[k] for k in chain]
            assert times == sorted(times), (chain, times)
    finally:
        srv.close()
