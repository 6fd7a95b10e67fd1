"""The program's own spans and counters (multimodalmusig_tpu_torch's
utils/profiling.py), as the per-layer readers take them.

A `--trace 1` run traces two sets of the same fits after the window
(portbench/harness.py `_traced_fits`): first under the program's tracer
alone, then under torch.profiler too, which slows the host (1.0-1.75x, and
about 4 us more a graph node replayed). Each set keeps a `snapshot` of the
tracer, `run["program"]["unprofiled"]` and `run["program"]["profiled"]`.
`totals(run)` reads the unprofiled set, so a reader of host time reads the
host as the window ran it without asking; a reader that has to agree with
the device trace asks for the profiled set. A checkout whose package has
no tracer, or a set in which it recorded nothing, reads None, and so does
a set whose lane steps (`loop.lane_steps`) differ from those the
harness's step wrapper counted in the same fits, as the roofline readers
check the kernel calls against the wrappers' launches.
"""

from __future__ import annotations

import contextlib


def _profiling():
    try:
        from multimodalmusig_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "totals"):
        return None
    return profiling


def recording():
    """The program's tracer records within the block (nothing for a package
    without one)."""
    profiling = _profiling()
    return contextlib.nullcontext() if profiling is None else profiling.tracing()


def reset():
    """Forget what the program's tracer recorded."""
    profiling = _profiling()
    if profiling is not None:
        profiling.reset()


def snapshot(lane_steps):
    """What the program's tracer holds now, {"totals", "records" (its span
    records), "lane_steps" (the harness's count in the same fits)}, or None
    for a package without a tracer."""
    profiling = _profiling()
    if profiling is None:
        return None
    return {"totals": profiling.totals(), "records": profiling.spans(full=True),
            "lane_steps": lane_steps}


def totals(run, profiled=False):
    """{"spans": {name: {"calls", "s", "self_s"}}, "counts": {name: n},
    "records": [span records]} of the unprofiled traced fits (with
    `profiled`, of the profiled ones), or None."""
    snap = (run.get("program") or {}).get("profiled" if profiled else "unprofiled")
    if not snap:
        return None
    t = snap["totals"]
    if not t["spans"] or t["counts"].get("loop.lane_steps") != snap["lane_steps"]:
        return None
    return dict(t, records=snap["records"])


def seconds(t, name):
    """The seconds of the spans named `name` (0 when none closed)."""
    return t["spans"].get(name, {}).get("s", 0.0)


def calls(t, name):
    return t["spans"].get(name, {}).get("calls", 0)


def seconds_inside(t, inner, outer):
    """The seconds of the spans named `inner` that lie inside a span named
    `outer`, from the span records of `t`."""
    records = t["records"]
    total = 0
    for rec in records:
        if rec["name"] != inner or rec["end_ns"] is None:
            continue
        p = rec["parent"]
        while p >= 0 and records[p]["name"] != outer:
            p = records[p]["parent"]
        if p >= 0:
            total += rec["end_ns"] - rec["start_ns"]
    return total * 1e-9
