"""The device trace of the profiled fits: busy time, idle gaps and the
kernels' device time, from torch.profiler's device events (the profiler
records the card's activity only).

Spans on the profiler's clock, `time.time_ns()`, name what the host was
doing during each idle gap: the innermost span open at the gap's start.
They are the union of the harness's spans (portbench/instrument.py,
`Recorder.tracing`), around the calls it wraps, and the program's own
span records (its utils/profiling.py), inside them; where the program
recorded nothing, the harness's alone.
"""

from __future__ import annotations

ETA_KERNEL = "estep_eta"       # B3: estep_eta_{thread,warp,block}_kernel
THETA_KERNEL = "theta_moments"  # B4: theta_moments_kernel[_chunk]


def _is_device(ev):
    return str(ev.device_type()).endswith("CUDA")


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events, spans, t0_ns, t1_ns, program=()):
    """From the profiler's raw events (`kineto_results.events()`), the
    harness's spans [(start_ns, end_ns, name)] and the program's span
    records [{"name", "start_ns", "end_ns", ...}] (`profiling.spans(full=
    True)`), inside [t0_ns, t1_ns): {"busy_s", "window_s", "eta": [calls,
    s], "theta": [calls, s], "device_ops": top 10 [name, s], "idle_gaps":
    [span, s]} (times as measured). `idle_gaps` holds every span that idle
    time was charged to, longest first, if they are ten at most, else the
    nine longest and "other spans", the rest together, so that it sums to
    the whole idle time."""
    dev, first = [], None
    for ev in events:
        if not _is_device(ev):
            continue
        start, end = ev.start_ns(), ev.end_ns()
        first = start if first is None else min(first, start)
        if end <= t0_ns or start >= t1_ns:
            continue
        dev.append((max(start, t0_ns), min(end, t1_ns), ev.name()))
    spans = list(spans) + [(r["start_ns"], r["end_ns"], r["name"]) for r in program
                           if r["end_ns"] is not None]
    # a span of no length holds no gap's start (and, its end sorting before
    # its start, would stay open in the sweep)
    spans = [sp for sp in spans if sp[1] > max(t0_ns, sp[0]) and sp[0] < t1_ns]
    kernels = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    # sweep in time order with a stack of open spans (they nest; of two
    # that open at one time the longer first): each idle gap is charged to
    # the innermost span open where it starts
    marks = [(s, 1, -e, i) for i, (s, e, _) in enumerate(spans)]
    marks += [(e, 0, 0, i) for i, (_, e, _) in enumerate(spans)]
    prev = t0_ns
    for s, e in busy + [[t1_ns, t1_ns]]:
        if s > prev:
            marks.append((prev, 2, 0, s - prev))
        prev = max(prev, e)
    gaps, stack = {}, []
    for _, kind, _, x in sorted(marks, key=lambda m: m[:3]):
        if kind == 1:
            stack.append(x)
        elif kind == 0:
            if x in stack:
                stack.remove(x)
        else:
            name = spans[stack[-1]][2] if stack else "host (no span)"
            gaps[name] = gaps.get(name, 0.0) + x * 1e-9

    def family(prefix):
        hits = [v for n, v in kernels.items() if prefix in n]
        return [sum(c for c, _ in hits), sum(t for _, t in hits)]

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    idle = sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])
    if len(idle) > 10:
        idle = idle[:9] + [["other spans", sum(s for _, s in idle[9:])]]
    return {
        "busy_s": busy_s,
        "window_s": (t1_ns - t0_ns) * 1e-9,
        # the first device event after the first span opened: a check that
        # the two clocks agree (a few ms at most)
        "first_device_s": None if first is None else (first - t0_ns) * 1e-9,
        "eta": family(ETA_KERNEL),
        "theta": family(THETA_KERNEL),
        "device_ops": [[n[:120], v[1]] for n, v in top],
        "idle_gaps": idle,
    }
