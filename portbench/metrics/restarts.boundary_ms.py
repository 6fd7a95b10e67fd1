"""restarts.boundary_ms (ms): the host's time at the boundaries of the fit
loops per selected model: the program's `loop.boundary` spans (after each
segment of `run_cavi` the (n_iters, done) read and the gathers, after the
last one the final gather) over its `restarts.fits`, in the unprofiled
traced fits (portbench/program_trace.py)."""

from portbench import program_trace


def read(run):
    t = program_trace.totals(run)
    if t is None or not t["counts"].get("restarts.fits"):
        return None
    return 1e3 * program_trace.seconds(t, "loop.boundary") / t["counts"]["restarts.fits"]
