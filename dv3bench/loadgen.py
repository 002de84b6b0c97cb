# coding: utf-8
"""Open-loop HTTP load for the port's `/tts` endpoint: every request is
sent when it is due, whatever the server has answered so far, and every
response is read to its end.

    python3 dv3bench/loadgen.py --port <p> --t0 <wall time> < schedule.json

The schedule on standard input is a list of [due offset s, text, speaker id
or null]; request i is sent at t0 + its offset, from a thread of its own.
Prints one JSON list on standard output, a record per request in schedule
order: due, sent, status, first_pcm (wall time of the first PCM bytes after
the WAV header, null if none came), end and pcm_bytes. The arrivals come
from generate.arrivals."""

import http.client
import json
import sys
import threading
import time
from urllib.parse import urlencode

WAV_HEADER = 44


def fetch(port, text, speaker, rec, timeout=120.0):
    """One request, read to its end; fills rec."""
    q = {"text": text}
    if speaker is not None:
        q["speaker_id"] = speaker
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        rec["sent"] = time.time()
        conn.request("GET", "/tts?" + urlencode(q))
        resp = conn.getresponse()
        rec["status"] = resp.status
        if resp.status != 200:
            resp.read()
            return
        head = resp.read(WAV_HEADER)
        if len(head) < WAV_HEADER:
            return
        first = resp.read(2)
        if first:
            rec["first_pcm"] = time.time()
        rec["pcm_bytes"] = len(first) + len(resp.read())
    except (OSError, http.client.HTTPException) as e:
        rec["error"] = repr(e)
    finally:
        rec["end"] = time.time()
        conn.close()


def run(port, t0, sched):
    recs = [{"due": t0 + d, "sent": None, "status": None, "first_pcm": None,
             "end": None, "pcm_bytes": 0} for d, _, _ in sched]
    threads = []
    for (d, text, spk), rec in zip(sched, recs):
        wait = t0 + d - time.time()
        if wait > 0:
            time.sleep(wait)
        th = threading.Thread(target=fetch, args=(port, text, spk, rec),
                              daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    return recs


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--t0", type=float, required=True)
    a = p.parse_args(argv)
    sched = json.load(sys.stdin)
    print(json.dumps(run(a.port, a.t0, sched)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
