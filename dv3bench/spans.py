# coding: utf-8
"""The program's own spans and counters in the traced window, for the
readers that need them (metrics/synth.to_host.batch.py and the others that
import this module).

The port keeps them in memory while the profiler records
(`deepvoice3_pytorch_tpu_torch.utils.profiling`: `recorded()` gives the
window). The spans carry `time.time_ns()` stamps; the window's `dv3.clock`
markers, which the profiler saw as host ops, put them on the trace's µs
axis. Only the trees under a `dv3.tts_batch` root are read, and only when
those roots are the traced calls (rows, padded text length and steps asked
as `ctx["calls"]` has them). A program without the recorder, or a window
the trace does not match, gives None and every reader here leaves its
metric out.

Idle time is the device's time with no kernel running, as
`device.idle.batch` counts it (copies are idle). Each stretch of it goes to
the innermost span at its middle, as `Trace.idle_gaps` names a gap by the
innermost host op; a stretch that runs across span boundaries is cut at
them first, so each piece goes to the span it lies in. The program gives
each span its class where it opens it (`stage`: "host" or "device"); the
idle time of a call's root itself (between its stages) and outside every
call is the remainder."""

import numpy as np

CALL = "dv3.tts_batch"

_last = [None, None]        # (trace, its reading): the readers share one


def window(ctx):
    """The recorder's window of the traced run and its offset onto the
    trace's axis (µs), or None."""
    if ctx.get("kind") != "batch":
        return None
    try:
        from deepvoice3_pytorch_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    w = recorded()
    if w is None or not w.spans:
        return None
    marks = sorted((s, e) for n, s, e in ctx["trace"].host
                   if n == profiling.CLOCK)
    off = profiling.clock_offset_us(w, marks)
    return None if off is None else (w, off)


def reading(ctx):
    """None, or {"spans": [(name, start µs, end µs, parent, stage)] of the
    traced calls on the trace's axis, "idle_s": {span name: idle seconds
    whose innermost span it is}, "idle_stage_s": {stage: idle seconds},
    "unclassified": names of spans under a call with no stage,
    "idle_outside_s": the rest of the window's idle time, "counters",
    "window": the recorder's window}."""
    if _last[0] is ctx.get("trace") and _last[0] is not None:
        return _last[1]
    got = window(ctx)
    out = None
    if got is not None:
        w, off = got
        out = _read(ctx, w, off)
    _last[:] = [ctx.get("trace"), out]
    return out


def _read(ctx, w, off):
    calls = {s.call for s in w.spans if s.parent < 0 and s.name == CALL}
    done = [s for s in w.spans if s.call in calls and s.end is not None]
    roots = [s for s in done if s.parent < 0]
    shapes = [(s.attrs.get("rows"), s.attrs.get("text_padded"),
               s.attrs.get("steps_asked")) for s in roots]
    if shapes != [tuple(c[:3]) for c in ctx.get("calls", [])]:
        return None
    at = {s.index: k for k, s in enumerate(done)}
    spans = [(s.name, s.start / 1e3 + off, s.end / 1e3 + off,
              at.get(s.parent, -1), s.stage) for s in done]
    tr = ctx["trace"]
    idle = idle_by_span(spans, [(s, t) for _, s, t in tr.kernels()])
    by_name, by_stage, unclassified = {}, {}, set()
    for (name, _, _, parent, stage), t in zip(spans, idle):
        by_name[name] = by_name.get(name, 0.0) + t
        if stage is not None:
            by_stage[stage] = by_stage.get(stage, 0.0) + t
        elif parent >= 0:
            unclassified.add(name)
    total = max(0.0, tr.window_s - tr.kernel_busy_s)
    return {"spans": spans, "idle_s": by_name, "idle_stage_s": by_stage,
            "unclassified": sorted(unclassified),
            "idle_outside_s": total - sum(idle),
            "counters": w.counters(), "window": w}


def idle_by_span(spans, kernels):
    """Seconds with no kernel running whose innermost span is each of
    `spans` [(name, start µs, end µs, parent index, ...)], in their order;
    kernels: [(start µs, end µs)]."""
    if not spans:
        return []
    cuts = np.unique(np.array([x for _, s, e, *_ in spans for x in (s, e)]))
    owner = np.full(len(cuts) - 1, -1)
    depth = [0] * len(spans)
    for i, (_, _, _, p, *_) in enumerate(spans):
        depth[i] = depth[p] + 1 if 0 <= p < i else 0
    for i in sorted(range(len(spans)), key=lambda j: depth[j]):
        a, b = np.searchsorted(cuts, spans[i][1:3])
        owner[a:b] = i                  # the deepest span wins
    busy = _busy_upto(kernels, cuts)
    idle = np.diff(cuts) - np.diff(busy)
    out = [0.0] * len(spans)
    for seg in np.nonzero(owner >= 0)[0]:
        out[owner[seg]] += float(idle[seg]) / 1e6
    return out


def _busy_upto(kernels, t):
    """µs in which some kernel ran, from the trace's start up to each of
    the times t."""
    u = []
    for s, e in sorted(kernels):
        if u and s <= u[-1][1]:
            u[-1][1] = max(u[-1][1], e)
        else:
            u.append([s, e])
    if not u:
        return np.zeros(len(t))
    u = np.array(u)
    done = np.concatenate([[0.0], np.cumsum(u[:, 1] - u[:, 0])])
    i = np.searchsorted(u[:, 0], t, side="right")    # intervals begun by t
    last = np.clip(i - 1, 0, len(u) - 1)
    part = np.where(i > 0, np.clip(t - u[last, 0], 0,
                                   u[last, 1] - u[last, 0]), 0.0)
    return done[np.maximum(i - 1, 0)] + part


def idle_share(ctx, stage):
    """% of the traced window with no kernel running inside the calls'
    spans of class `stage` (as innermost span), or None; None too when a
    span under a call has no class (its idle time would fall out of both
    classes unseen)."""
    r = reading(ctx)
    if r is None or r["unclassified"]:
        return None
    return 100.0 * r["idle_stage_s"].get(stage, 0.0) / ctx["trace"].window_s


def span_idle_share(ctx, name):
    """% of the traced window with no kernel running inside the calls'
    spans `name` (as innermost span), or None without such a span."""
    r = reading(ctx)
    if r is None or name not in r["idle_s"]:
        return None
    return 100.0 * r["idle_s"][name] / ctx["trace"].window_s
