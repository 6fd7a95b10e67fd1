"""kernel.launch_host_us (us): the host's time in one call of the η or θ
kernel's wrapper, from entry to the launch's return (argument checks, the
outputs' allocation, the layout, the ctypes call), from the program's
`kernel.eta_host` and `kernel.theta_host` spans over their calls, in the
unprofiled traced fits (portbench/program_trace.py)."""

from portbench import program_trace

SPANS = ("kernel.eta_host", "kernel.theta_host")


def read(run):
    t = program_trace.totals(run)
    if t is None:
        return None
    n = sum(program_trace.calls(t, s) for s in SPANS)
    if n == 0:
        return None
    return 1e6 * sum(program_trace.seconds(t, s) for s in SPANS) / n
