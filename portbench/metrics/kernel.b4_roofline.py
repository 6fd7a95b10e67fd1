"""kernel.b4_roofline (%): the frozen bound of every θ kernel call of the
traced fits (portbench/yardstick.py `theta_bound`) over the profiler's
summed device time of the theta_moments kernels. Nothing when the calls,
the launches and the kernels disagree."""


def read(run):
    t, k = run.get("trace"), run.get("traced", {}).get("theta")
    if not t or not k or k["calls"] == 0:
        return None
    calls, device_s = t["theta"]
    if not (calls == k["calls"] == k["launches"]) or device_s <= 0:
        return None
    return 100.0 * k["bound_s"] / device_s
