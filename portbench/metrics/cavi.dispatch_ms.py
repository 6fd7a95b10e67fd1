"""cavi.dispatch_ms (ms): the host's time to issue one CAVI step, from the
program's own spans: its `step` span (the closure of `mmctm.fit_step_fn`:
E-step, M-step, γ, lls, unsynchronized) over its `loop.steps`, in the
unprofiled traced fits (portbench/program_trace.py)."""

from portbench import program_trace


def read(run):
    t = program_trace.totals(run)
    if t is None or not t["counts"].get("loop.steps"):
        return None
    return 1e3 * program_trace.seconds(t, "step") / t["counts"]["loop.steps"]
