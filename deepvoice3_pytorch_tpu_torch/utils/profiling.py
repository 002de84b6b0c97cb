# coding: utf-8
"""Tracing and profiler traces of the port, counterpart of
deepvoice3_pytorch_tpu/utils/profiling.py (which imports jax, so the port
keeps its own copy).

  * rss_mb — this process's resident set size;
  * span / count — the recorder: named spans and counters at the layer
    boundaries of the program (`synthesis.tts_batch` and what it calls),
    kept in memory while a torch.profiler session records, or inside
    `recording()`; `recorded()` gives the newest such window;
  * fold_b1_stamps — where a launch of kernel B1 spent its time, from the
    stamps the kernel writes (`fold_b1_stamps_by_kind`: by its stages'
    kinds);
  * TraceWindow — a torch.profiler trace of the CPU and the card over a step
    range, written as one Chrome trace (viewable in Perfetto) per window.

While nothing records, a span or a count only checks that nothing
records: it keeps nothing and reads no clock. While a window records, a
span keeps its name (prefix `dv3.`), its class (`stage`: "host" for work
the device waits on, "device" for work that launches device operations,
None for a span that holds both, such as a call), its start and end from
`time.time_ns()`, the index of its parent span and the call id of the root
span it runs under (one id a root: a `dv3.tts_batch` call, or a lower
layer's span when that layer is called on its own). Spans stay out of the
profiler's own ranges: a `record_function` around launches becomes a
device-side annotation that a trace reader would take for a kernel. The
one range the recorder enters is `dv3.clock`, a few empty markers at the
window's first span, which put the spans on the profiler's time axis
(`Window.clock`).
"""

import contextlib
import os
import threading
import time

import numpy as np
import torch

_profiler_on = torch._C._autograd._profiler_enabled

CLOCK = "dv3.clock"
CLOCK_MARKS = 3     # the first record_function of a session is slow and
#                     lopsided; the reader aligns by the tightest marker
STAMP_SLAB = 1 << 20    # int64 entries of a device buffer of B1 stamps
# what fold_b1_stamps_by_kind gives a kind: work = products + epilogue
KIND_PARTS = ("work_ns", "products_ns", "epilogue_ns", "barrier_ns")
STAGES = ("host", "device")


def rss_mb(default=float("nan")):
    """Resident-set size of this process in MiB (Linux /proc); `default`
    when VmRSS is unavailable."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return default


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class Span:
    """One recorded span: `name`, `stage` (None, or one of STAGES), `start`
    and `end` (ns, `time.time_ns()`), `parent` (index into the window's
    spans, -1 for a root), `call` (the root span's id) and `attrs`."""

    __slots__ = ("name", "stage", "start", "end", "parent", "call", "attrs",
                 "index", "_window")

    def __init__(self, window, name, stage, attrs):
        self._window = window
        self.name = name
        self.stage = stage
        self.attrs = attrs
        self.start = self.end = None
        self.parent = -1
        self.call = self.index = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def stamps(self, n_stages, steps, device, kinds=None):
        """A stamp buffer for one launch of kernel B1 of `steps` steps of
        `n_stages` stages (2 + 3 * steps * n_stages int64 on `device`),
        kept with the window and folded when the window is read; None for
        the plain decoder (n_stages 0). kinds: the kind of each stage
        (`fused_decode.b1_stage_kinds`), kept with the buffer for the
        window's split by kind."""
        if not n_stages:
            return None
        buf = _REC.stamp_buffer(2 + 3 * steps * n_stages, device)
        self._window.stamps.append((buf, steps, n_stages, kinds))
        return buf

    def __enter__(self):
        w = self._window
        stack = _REC.stack()
        parent = stack[-1] if stack and stack[-1]._window is w else None
        with _REC.lock:
            if parent is None:
                w.n_calls += 1
                self.call = w.n_calls
            else:
                self.parent, self.call = parent.index, parent.call
            self.index = len(w.spans)
            w.spans.append(self)
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _REC.stack().pop()
        return False


class _Off:
    """The span of a call made while nothing records (false, so a caller
    can skip work that only feeds a recorded span)."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def stamps(self, n_stages, steps, device, kinds=None):
        return None


_OFF = _Off()


class Window:
    """What one profiled window or `recording()` block recorded: `spans`
    (in the order they began), `clock` (the `dv3.clock` markers, each the
    (ns, ns) read inside it), the counters (`counters()`) and B1's stamps
    (`b1_split()`)."""

    def __init__(self):
        self.spans = []
        self.clock = []
        self.stamps = []        # (int64 buffer, steps, stages[, kinds])
        self.n_calls = 0
        self._counts = {}

    def mark_clock(self):
        for _ in range(CLOCK_MARKS):
            with torch.profiler.record_function(CLOCK):
                a = time.time_ns()
                b = time.time_ns()
            self.clock.append((a, b))

    def add(self, name, n):
        with _REC.lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self):
        return dict(self._counts)

    def b1_split(self):
        """Kernel B1's launches in the window folded (`fold_b1_stamps`) and
        summed: launches, launch_ns, prologue_ns, work_ns, barrier_ns, and
        where every launch's buffer was kept with its stages' kinds,
        `kinds`: {kind: {work_ns, products_ns, epilogue_ns, barrier_ns}}
        (`fold_b1_stamps_by_kind`), whose work and barrier sum to the
        totals; None without stamps. Reads the buffers back (waits for the
        device)."""
        if not self.stamps:
            return None
        total = dict(launches=0, launch_ns=0, prologue_ns=0, work_ns=0,
                     barrier_ns=0)
        by_kind, all_kinds = {}, True
        for buf, steps, n_stages, *kinds in self.stamps:
            t = buf.cpu().numpy()
            one = fold_b1_stamps(t, steps, n_stages)
            if one is None:
                continue
            total["launches"] += 1
            for k, v in one.items():
                total[k] += v
            kinds = kinds[0] if kinds else None
            if kinds is None:
                all_kinds = False
                continue
            for kind, part in fold_b1_stamps_by_kind(
                    t, steps, n_stages, kinds).items():
                acc = by_kind.setdefault(kind, dict.fromkeys(KIND_PARTS, 0))
                for k, v in part.items():
                    acc[k] += v
        if not total["launches"]:
            return None
        if all_kinds:
            total["kinds"] = by_kind
        return total


class _Recorder:
    def __init__(self):
        self.forced = 0             # depth of recording() blocks
        self.live = False           # the window takes this session's spans
        self.window = None
        self.lock = threading.Lock()
        self._local = threading.local()
        self._slabs = {}            # device -> [int64 buffers], reused
        self._used = {}             # device -> (slab, offset) this window

    def stack(self):
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def current(self):
        """The window of this session, begun at its first span or count."""
        if not self.live:
            self.window = Window()
            self._used = {}
            self.live = True
        w = self.window
        if not w.clock and _profiler_on():
            w.mark_clock()
        return w

    def stamp_buffer(self, n, device):
        """n int64 on `device`, a slice of a buffer kept from window to
        window (allocated, zeroed, only when the kept ones are full)."""
        key = str(device)
        slabs = self._slabs.setdefault(key, [])
        i, off = self._used.get(key, (0, 0))
        while i < len(slabs) and off + n > slabs[i].numel():
            i, off = i + 1, 0
        if i == len(slabs):
            slabs.append(torch.zeros(max(STAMP_SLAB, n), dtype=torch.int64,
                                     device=device))
        self._used[key] = (i, off + n)
        return slabs[i][off:off + n]


_REC = _Recorder()


def span(name, stage=None, **attrs):
    """A span `name` of class `stage` (None, "host" or "device") around a
    `with` block: recorded while a profiler session records or inside
    `recording()`; otherwise a shared do-nothing span. The span's
    `set(**attrs)` adds attributes; its `stamps(...)` gives kernel B1 a
    stamp buffer."""
    if _REC.forced or _profiler_on():
        if stage is not None and stage not in STAGES:
            raise ValueError("span %s: stage %r is not one of %s"
                             % (name, stage, STAGES))
        return Span(_REC.current(), name, stage, attrs)
    _REC.live = False
    return _OFF


def count(name, n=1):
    """Add n to the counter `name` of the recording window, if any."""
    if _REC.forced or _profiler_on():
        _REC.current().add(name, n)
        return
    _REC.live = False


@contextlib.contextmanager
def recording():
    """Record spans and counters in a new window for the block, without a
    profiler session (tests, operators). Yields the window."""
    with _REC.lock:
        _REC.forced += 1
        if _REC.forced == 1:
            _REC.live = False
    try:
        yield _REC.current()
    finally:
        with _REC.lock:
            _REC.forced -= 1
        if not _REC.forced:
            _REC.live = False


def recorded():
    """The newest window (`Window`) a profiler session or a `recording()`
    block recorded, or None."""
    return _REC.window


def _b1_stage_times(t, steps, n_stages):
    """(stamps, work, barrier, products) ns of each stage of each step of
    one launch, in launch order, from its stamps; None if they do not run
    forward."""
    t = np.asarray(t, np.int64)
    if t.shape != (2 + 3 * steps * n_stages,) or (np.diff(t) < 0).any() \
            or t[0] <= 0:
        return None
    passed = np.concatenate([t[1:2], t[4::3]])      # barrier exits
    return (t, t[3::3] - passed[:-1], t[4::3] - t[3::3],
            t[2::3] - passed[:-1])


def fold_b1_stamps(t, steps, n_stages):
    """One launch of kernel B1 from its stamps (block 0's globaltimer, ns):
    t[0] at the launch's start, t[1] after its prologue (and the grid
    barrier that ends it), then for each stage of each step its first part
    done (products or scores), its work done, and the grid barrier after
    it passed. Returns {launch_ns, prologue_ns, work_ns, barrier_ns}, where
    launch = prologue + work + barrier runs from the start to the last
    barrier; barrier_ns is block 0's wait from its work done to the barrier
    passed (the slowest block's lag and the barrier's own cost). None if
    the stamps do not run forward (a buffer the launch did not fill)."""
    got = _b1_stage_times(t, steps, n_stages)
    if got is None:
        return None
    t, work, barrier, _ = got
    return dict(launch_ns=int(t[-1] - t[0]), prologue_ns=int(t[1] - t[0]),
                work_ns=int(work.sum()), barrier_ns=int(barrier.sum()))


def fold_b1_stamps_by_kind(t, steps, n_stages, kinds):
    """One launch's work and barrier wait (as `fold_b1_stamps` counts them)
    by the kind of the stage they follow: {kind: {work_ns, products_ns,
    epilogue_ns, barrier_ns}}, kinds[s] the kind of stage s of every step.
    A stage's work splits at its first stamp into products_ns (from the
    barrier before it to its products done: an MV stage's matrix-vector
    product, an ATT stage's scores) and epilogue_ns (the rest of its work),
    which sum to work_ns. The kinds' sums are the launch's work_ns and
    barrier_ns. None where `fold_b1_stamps` is."""
    if len(kinds) != n_stages:
        raise ValueError("%d kinds for %d stages" % (len(kinds), n_stages))
    got = _b1_stage_times(t, steps, n_stages)
    if got is None:
        return None
    _, work, barrier, products = got
    parts = {"work_ns": work, "products_ns": products,
             "epilogue_ns": work - products, "barrier_ns": barrier}
    parts = {k: v.reshape(steps, n_stages).sum(axis=0).tolist()
             for k, v in parts.items()}
    out = {}
    for s, kind in enumerate(kinds):
        acc = out.setdefault(kind, dict.fromkeys(KIND_PARTS, 0))
        for k in KIND_PARTS:
            acc[k] += int(parts[k][s])
    return out


def clock_offset_us(window, events):
    """µs to add to a span's time (ns / 1e3) to put it on the axis of a
    trace whose `dv3.clock` events are `events` [(start µs, end µs)], in
    order; None when they do not match the window's markers. Each marker's
    time read inside it is matched to the event's middle; the tightest
    event (the least time spent entering and leaving) gives the offset."""
    if window is None or not window.clock or \
            len(events) != len(window.clock):
        return None
    best = min(zip(window.clock, events), key=lambda m: m[1][1] - m[1][0])
    (a, b), (s, e) = best
    return 0.5 * (s + e) - 0.5 * (a + b) / 1e3


# ---------------------------------------------------------------------------
# profiler traces
# ---------------------------------------------------------------------------


class TraceWindow:
    """A torch.profiler trace over steps [start, start + num), written to
    `log_dir/trace_steps<start>-<stop - 1>.json`."""

    def __init__(self, log_dir, start_step, num_steps=5):
        self.log_dir = log_dir
        self.start = start_step
        self.stop = start_step + num_steps
        self._prof = None

    def maybe_start(self, step):
        if self.log_dir and self._prof is None and step == self.start:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            print("profiler: tracing steps %d..%d -> %s"
                  % (self.start, self.stop - 1, self.log_dir))

    def maybe_stop(self, step):
        if self._prof is not None and step >= self.stop:
            self.close()

    def close(self):
        if self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace_steps%d-%d.json"
                            % (self.start, self.stop - 1))
        prof.export_chrome_trace(path)
        print("profiler: trace written to %s" % path)
