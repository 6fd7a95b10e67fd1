"""cavi.step_ms (ms): the fit loops' (`run_cavi`) whole time over the
window divided by all their steps."""


def read(run):
    return 1e3 * run["loop_s"] / run["steps"] if run["steps"] else None
