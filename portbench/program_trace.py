"""The program's own spans and counters (multimodalmusig_tpu_torch's
utils/profiling.py), as the per-layer readers take them.

The program records them while a torch.profiler session records, so after
a `--trace 1` run they hold exactly the traced fits: the harness profiles
nothing else. A checkout whose package has no tracer, or one that recorded
nothing, reads None, and so does one whose lane steps (`loop.lane_steps`)
differ from those the harness's step wrapper counted in the same fits
(`run["traced"]["lane_steps"]`), as the roofline readers check the kernel
calls against the wrappers' launches.
"""

from __future__ import annotations


def _profiling():
    try:
        from multimodalmusig_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "totals"):
        return None
    return profiling


def totals(run):
    """{"spans": {name: {"calls", "s", "self_s"}}, "counts": {name: n}} of
    the traced fits, or None."""
    traced = run.get("traced")
    profiling = _profiling()
    if not traced or profiling is None:
        return None
    t = profiling.totals()
    if not t["spans"] or t["counts"].get("loop.lane_steps") != traced["lane_steps"]:
        return None
    return t


def seconds(t, name):
    """The seconds of the spans named `name` (0 when none closed)."""
    return t["spans"].get(name, {}).get("s", 0.0)


def calls(t, name):
    return t["spans"].get(name, {}).get("calls", 0)


def seconds_inside(inner, outer):
    """The seconds of the spans named `inner` that lie inside a span named
    `outer`, from the program's span records."""
    records = _profiling().spans(full=True)
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
