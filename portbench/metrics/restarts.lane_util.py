"""restarts.lane_util (%): the lane-iterations the restart lanes needed
until they finished (Σ n_iters of every fit phase: pilot, compacted
segments, stages 1 and 2) over the lane-iterations the steps computed
(Σ over CAVI steps of the lanes in the batch), over the window."""


def read(run):
    if not run["lane_steps"]:
        return None
    return 100.0 * run["lane_iters_needed"] / run["lane_steps"]
