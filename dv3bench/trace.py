# coding: utf-8
"""The traced window: torch.profiler over a fixed piece of work, reduced to
what the per-layer readers and the result line need. Device intervals are
the profiler's CUDA events (kernels, copies, sets: CUPTI sees the kernels
the port launches through ctypes too); the host's ops are its CPU events."""

import time

import numpy as np


def profiled(torch, fn, cuda=True):
    """Run fn() under the profiler, synchronised at both ends. Returns
    (fn's return value, Trace). cuda=False traces the host alone (the
    CPU rehearsal of the tests)."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if tr.end <= tr.start:
            continue
        (dev if _device(e) else host).append(
            (e.name, float(tr.start), float(tr.end)))
    return out, Trace(dev, host, window_s)


def _device(e):
    return str(getattr(e, "device_type", "")).split(".")[-1] == "CUDA"


class Trace:
    """device, host: [(name, start µs, end µs)] of the window's device
    operations and host ops."""

    def __init__(self, device, host, window_s):
        self.window_s = window_s
        self.device = device
        self.host = host
        self._union = _union([(s, t) for _, s, t in device])

    @property
    def busy_s(self):
        """Seconds in which some operation (a kernel, a copy or a set) ran
        on the device."""
        return sum(t - s for s, t in self._union) / 1e6

    @property
    def kernel_busy_s(self):
        """Seconds in which some kernel ran on the device (copies and sets
        left out: the card's compute units are idle through them)."""
        return sum(t - s for s, t in _union(
            [(s, t) for _, s, t in self.kernels()])) / 1e6

    def device_seconds(self, match):
        """(seconds, launches) of the device events whose name matches."""
        ev = [(s, t) for n, s, t in self.device if match(n)]
        return sum(t - s for s, t in ev) / 1e6, len(ev)

    def kernels(self):
        """Device events that are kernels (not copies or sets)."""
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def device_ops(self, n=10):
        by = {}
        for name, s, t in self.device:
            by[name] = by.get(name, 0.0) + (t - s) / 1e6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10, look_at=400):
        """The longest idle stretches of the device between its first and
        last operation, summed by the host op that ran across each one's
        middle (the innermost such op)."""
        u = self._union
        gaps = sorted(((u[i + 1][0] - u[i][1], u[i][1], u[i + 1][0])
                       for i in range(len(u) - 1)), reverse=True)[:look_at]
        if not gaps:
            return []
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host] or [0.0])
        he = np.array([h[2] for h in self.host] or [0.0])
        by = {}
        for length, s, t in gaps:
            mid = 0.5 * (s + t)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = "host: no op"
            if len(inside):
                name = names[inside[np.argmin((he - hs)[inside])]]
            by[name] = by.get(name, 0.0) + length / 1e6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]


def _union(iv):
    out = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out
