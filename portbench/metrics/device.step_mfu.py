"""device.step_mfu (%): the operations of the traced fits' CAVI steps
(portbench/yardstick.py `step_flops_per_lane` at its frozen budgets,
times the lanes each step computed) over the seconds in which the card
was busy in the traced span (torch.profiler's device events) and the
card's float32 peak. Device time only: host dispatch does not enter it."""


def read(run):
    t, traced = run.get("trace"), run.get("traced")
    if not t or not traced or not traced["lane_steps"] or t["busy_s"] <= 0:
        return None
    c, y = run["config"], run["yardstick"]
    flops = y.step_flops_per_lane(c["D"], c["K"], c["V"]) * traced["lane_steps"]
    return 100.0 * flops / (t["busy_s"] * y.PEAK_F32_FLOPS)
