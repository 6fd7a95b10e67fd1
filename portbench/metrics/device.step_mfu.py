"""device.step_mfu (%): the operations of the traced fits' CAVI steps
(the cell's entry's `step_flops_per_lane(config)`; for MMCTM
portbench/yardstick.py `step_flops_per_lane` at its frozen budgets), times
the lanes each step computed, over the seconds in which the card was busy
in the traced span (torch.profiler's device events) and the card's float32
peak. Device time only: host dispatch does not enter it. Nothing for an
entry that counts no step's operations."""


def read(run):
    t, traced = run.get("trace"), run.get("traced")
    per_lane = getattr(run.get("entry"), "step_flops_per_lane", None)
    if not t or not traced or not traced["lane_steps"] or t["busy_s"] <= 0 or per_lane is None:
        return None
    flops = per_lane(run["config"]) * traced["lane_steps"]
    return 100.0 * flops / (t["busy_s"] * run["yardstick"].PEAK_F32_FLOPS)
