"""restarts.outside_loops_share (%): the share of `fit_mmctm_restarts`
spent outside its fit loops (set-up, inits, the auto pilot's schedule, the
float64 rescoring, the graft, finalize_fit's ELBO, the model's fields to
the host), from the program's `restarts.fit` spans less the `loop.run`
spans inside them, in the unprofiled traced fits
(portbench/program_trace.py)."""

from portbench import program_trace


def read(run):
    t = program_trace.totals(run)
    if t is None:
        return None
    fit_s = program_trace.seconds(t, "restarts.fit")
    if fit_s <= 0:
        return None
    loops_s = program_trace.seconds_inside(t, "loop.run", "restarts.fit")
    return 100.0 * (fit_s - loops_s) / fit_s
