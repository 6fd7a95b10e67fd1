"""cavi.freeze_ms (ms): the host's time between a CAVI step's return and
the next step (the lane freeze `_select_lanes` over every state field, the
ll buffer, n_iters, the convergence test; `done.all()` reads excluded), from
the program's `loop.freeze` span over its `loop.steps`, in the unprofiled
traced fits (portbench/program_trace.py)."""

from portbench import program_trace


def read(run):
    t = program_trace.totals(run)
    if t is None or not t["counts"].get("loop.steps"):
        return None
    return 1e3 * program_trace.seconds(t, "loop.freeze") / t["counts"]["loop.steps"]
