"""kernel.b3_roofline (%): the frozen bound of every η kernel call of the
traced fits (portbench/yardstick.py `eta_bound`, operations at the card's
float32 peak) over the profiler's summed device time of the estep_eta
kernels. Nothing when the calls, the launches and the kernels disagree."""


def read(run):
    t, k = run.get("trace"), run.get("traced", {}).get("eta")
    if not t or not k or k["calls"] == 0:
        return None
    calls, device_s = t["eta"]
    if not (calls == k["calls"] == k["launches"]) or device_s <= 0:
        return None
    return 100.0 * k["bound_s"] / device_s
