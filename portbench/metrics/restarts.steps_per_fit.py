"""restarts.steps_per_fit (steps): CAVI steps per selected model over the
window, every phase of the fit counted (pilot, stage 1, stage 2)."""


def read(run):
    return run["steps"] / run["fits"] if run["fits"] else None
