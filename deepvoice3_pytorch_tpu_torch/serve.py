# coding: utf-8
"""Streaming TTS over HTTP, counterpart of the root serve.py: each request
is streamed as chunked-transfer WAV while it is synthesized, either one
utterance at a time (`streaming.tts_stream`, slots=0) or by continuous
batching (`serving.ContinuousBatcher`, slots=N: up to N utterances decode
together, new requests join at chunk boundaries).

Endpoints (`make_handler`):
    GET /tts?text=...[&speaker_id=N]
                        chunked WAV: a header with unknown (0xFFFFFFFF)
                        lengths, then 16-bit PCM chunks as they are made;
                        speaker_id picks the voice of a multi-speaker model
    GET /healthz        200 "ok"
    GET /stats          JSON: request counts, streams in flight, time to
                        first audio (last 512 requests: mean/p50/p95),
                        audio seconds produced, uptime; with slots, the
                        slot count, the waiting backlog, the active slots
                        and the batcher's time per step phase

With slots, admission control sheds a request once max_backlog requests
wait for a slot: HTTP 503 with Retry-After, counted as rejected.

`TTSServer` (a ThreadingHTTPServer that notes when it accepted each
connection) and the handler record, per /tts request, the wall times of its
hops to the first audio; `TTSEngine.hops()` returns the last 512.

The engine runs where the parameters live. The command line, which loads a
checkpoint, is `cli/serve.py`.
"""

import collections
import json
import queue
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from . import streaming
from .serving import BacklogFull, ContinuousBatcher, DeliveryQueue

# a request's hops to its first audio, in order (wall times, time.time()):
# the server accepted the connection, the handler thread started,
# engine.stream was entered, the request was queued (the batcher's submit
# returned), it was taken into a slot (batcher only), its first audio was
# put on its queue, the handler got it, the handler wrote it to the socket
HOPS = ("accept", "handler", "stream", "submit", "admit", "first_put",
        "first_get", "written")


def wav_stream_header(sample_rate, bits=16, channels=1):
    """RIFF/WAVE header with unknown (streaming) lengths."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                             byte_rate, block_align, bits),
        b"data", struct.pack("<I", 0xFFFFFFFF),
    ])


def pcm16(x):
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


class TTSEngine:
    """Model + streaming pipeline.

    slots=0: one utterance at a time. One producer thread, started here,
    synthesizes the requests in the order they came; each request's
    generator reads its chunks from a queue of its own, so a slow client
    never holds back the producer. The JAX engine starts a thread per
    request; here that would cost time to first audio, because PyTorch
    keeps per-thread state (cuDNN's execution plans, library handles) that
    every new thread builds again (chip_smoke.py phase `serve` measures a
    stream's first audio in fresh threads against the calling thread).

    slots=N: continuous batching. One worker thread, started here, runs
    the batcher's loop; the warm-up request goes through it too, so that
    the per-thread state is built on the thread that serves."""

    def __init__(self, params, cfg, ap, frontend_mod, max_decoder_steps,
                 slots=0, text_pad=64, max_backlog=None):
        self.params = params
        self.cfg = cfg
        self.ap = ap
        self.frontend = frontend_mod
        self.max_decoder_steps = max_decoder_steps
        self.batcher = None
        self._stop = threading.Event()
        if slots:
            self.batcher = ContinuousBatcher(
                params, cfg, ap, frontend_mod, n_slots=slots,
                text_pad=text_pad, max_decoder_steps=max_decoder_steps,
                max_backlog=max_backlog)
            self._worker = threading.Thread(
                target=self.batcher.run_loop, args=(self._stop,),
                daemon=True)
        else:
            self._jobs = queue.Queue()
            self._worker = threading.Thread(target=self._produce,
                                            daemon=True)
        self._worker.start()
        self._t_start = time.time()
        self._stats_lock = threading.Lock()
        self._counts = {"requests_total": 0, "requests_failed": 0,
                        "requests_rejected": 0, "requests_disconnected": 0,
                        "active_streams": 0, "audio_seconds_total": 0.0}
        self._ttfa_ms = collections.deque(maxlen=512)
        self._hops = collections.deque(maxlen=512)

    def shutdown(self):
        """Stop the worker: the producer once the queued requests are done,
        the batcher's loop after its current step."""
        if self.batcher is None:
            self._jobs.put(None)
        else:
            self._stop.set()

    def warmup(self):
        # _stream_inner directly: the warm-up request stays out of the
        # serving time-to-first-audio distribution
        for _ in self._stream_inner("warm up."):
            pass

    def stats(self):
        """Serving metrics snapshot (the /stats endpoint)."""
        with self._stats_lock:
            s = dict(self._counts)
            ttfa = sorted(self._ttfa_ms)
        s["audio_seconds_total"] = round(s["audio_seconds_total"], 3)
        if ttfa:
            n = len(ttfa)
            s["ttfa_ms"] = {
                "count": n,
                "mean": round(sum(ttfa) / n, 1),
                "p50": round(ttfa[n // 2], 1),
                "p95": round(ttfa[min(n - 1, int(0.95 * n))], 1),
            }
        s["slots"] = self.batcher.n_slots if self.batcher else 0
        if self.batcher is not None:
            # backlog: the waiting queue alone (what max_backlog is
            # compared with); the occupied slots separately
            s["backlog"] = self.batcher.waiting()
            s["active_slots"] = self.batcher.active_slots()
            # cumulative wall time per step phase: launches, the one
            # synchronisation, host DSP, retirements
            s["step_phase_ms"] = self.batcher.timing()
        s["uptime_s"] = round(time.time() - self._t_start, 1)
        return s

    def record_hops(self, trace):
        """Keep one request's trace: HOPS -> wall time (None where a hop
        did not happen) and its "text"."""
        q = trace.pop("queue", None)
        if q is not None:
            trace.update(admit=q.t_admit, first_put=q.t_first_put)
        rec = {h: trace.get(h) for h in HOPS}
        rec["text"] = trace.get("text")
        with self._stats_lock:
            self._hops.append(rec)

    def hops(self):
        """The last 512 requests' traces, oldest first."""
        with self._stats_lock:
            return list(self._hops)

    def stream(self, text, speaker_id=None, trace=None):
        """_stream_inner plus serving metrics: request, failure and
        rejection counts, streams in flight, time to first audio, audio
        seconds produced. trace: a dict that receives the wall times of the
        hops "stream" and "submit", and the request's queue."""
        if trace is not None:
            trace["stream"] = time.time()
        t0 = time.perf_counter()
        with self._stats_lock:
            self._counts["requests_total"] += 1
            self._counts["active_streams"] += 1
        n_samples, first = 0, True
        try:
            for audio in self._stream_inner(text, speaker_id=speaker_id,
                                            trace=trace):
                if first:
                    first = False
                    with self._stats_lock:
                        self._ttfa_ms.append(
                            (time.perf_counter() - t0) * 1000.0)
                n_samples += len(audio)
                yield audio
        except GeneratorExit:
            # a client that hangs up closes the generator: a disconnect,
            # not a synthesis failure
            with self._stats_lock:
                self._counts["requests_disconnected"] += 1
            raise
        except BaseException as e:
            key = ("requests_rejected" if isinstance(e, BacklogFull)
                   else "requests_failed")
            with self._stats_lock:
                self._counts[key] += 1
            raise
        finally:
            with self._stats_lock:
                self._counts["active_streams"] -= 1
                self._counts["audio_seconds_total"] += \
                    n_samples / float(self.ap.sample_rate)

    def _produce(self):
        """The producer thread: synthesizes each queued request into its
        queue, trimmed to the decoded length; None stops it."""
        while True:
            job = self._jobs.get()
            if job is None:
                return
            text, spk, q = job
            try:
                emitted = 0
                for chunk in streaming.tts_stream(
                        self.params, self.cfg, self.ap, self.frontend,
                        [text], speaker_ids=spk,
                        max_decoder_steps=self.max_decoder_steps):
                    audio = chunk["audio"][0]
                    if chunk["final"]:
                        # trim the post-done tail of the final emission
                        n_total = streaming.decoded_samples(
                            self.cfg, self.ap, chunk["decoded_steps"][0])
                        audio = audio[:max(0, n_total - emitted)]
                    emitted += len(audio)
                    if len(audio):
                        q.put(("audio", audio))
                q.put(("end", None))
            except BaseException as e:           # surface in the handler
                q.put(("error", e))

    def _stream_inner(self, text, speaker_id=None, trace=None):
        """Yields float32 sample chunks of one utterance, trimmed to the
        decoded length, as the producer thread or the batcher makes them."""
        if self.batcher is not None:
            q = self.batcher.submit(
                text, None if speaker_id is None else int(speaker_id))
        else:
            spk = None if speaker_id is None else [int(speaker_id)]
            q = DeliveryQueue()
            self._jobs.put((text, spk, q))
        if trace is not None:
            trace.update(submit=time.time(), queue=q)
        while True:
            try:
                kind, payload = q.get(timeout=600)
            except queue.Empty:
                return        # stalled producer: end the stream cleanly
            if kind == "end":
                return
            if kind == "error":
                raise payload
            yield payload


class TTSServer(ThreadingHTTPServer):
    """A ThreadingHTTPServer (a thread per connection) that notes the wall
    time at which it accepted each connection, for the handler's trace, and
    keeps a listen backlog for many clients that connect at once (the
    default 5 drops SYNs, and their retransmits would time TCP, not TTS).
    A connection's accept time lives as long as the connection: its first
    request takes it, and closing the connection drops it."""

    request_queue_size = 64

    def __init__(self, *args, **kwargs):
        self.accept_times = {}          # connection socket -> accept time
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        self.accept_times[request] = time.time()
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        self.accept_times.pop(request, None)
        super().shutdown_request(request)


def make_handler(engine):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            # the first request of a connection gets its accept time
            accepted = getattr(self.server, "accept_times", {}).pop(
                self.request, None)
            url = urlparse(self.path)
            if url.path == "/healthz":
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"ok")
                return
            if url.path == "/stats":
                self._json(200, engine.stats())
                return
            if url.path != "/tts":
                self._json(404, {"error": "unknown path %s" % url.path})
                return
            trace = {"handler": time.time(), "accept": accepted}
            q = parse_qs(url.query)
            text = (q.get("text") or [""])[0].strip()
            if not text:
                self._json(400, {"error": "missing ?text="})
                return
            trace["text"] = text
            speaker = (q.get("speaker_id") or [None])[0]
            try:
                gen = engine.stream(text, speaker_id=speaker, trace=trace)
                first = next(gen, None)
                trace["first_get"] = time.time()
            except BacklogFull as e:    # admission control: shed
                body = json.dumps({"error": str(e)}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            except Exception as e:  # synthesis errors as HTTP 500
                self._json(500, {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data):
                self.wfile.write(b"%x\r\n" % len(data))
                self.wfile.write(data)
                self.wfile.write(b"\r\n")

            chunk(wav_stream_header(engine.ap.sample_rate))
            if first is not None and len(first):
                chunk(pcm16(first))
            trace["written"] = time.time()
            engine.record_hops(trace)
            for audio in gen:
                chunk(pcm16(audio))
            self.wfile.write(b"0\r\n\r\n")

    return Handler
