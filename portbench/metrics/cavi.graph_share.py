"""cavi.graph_share (%): the share of the CAVI steps whose tail (the MMCTM
step after its E-step: μ, Σ, Σ⁻¹, γ, E[ln ϕ], the lls) replayed a CUDA
graph, from the program's `graph.replays.tail` counter over its
`loop.steps`, in the profiled traced fits, those of the device trace
(portbench/program_trace.py). None where the program counts no graph of
the tail, captured or replayed."""

from portbench import program_trace


def read(run):
    t = program_trace.totals(run, profiled=True)
    if t is None or not t["counts"].get("loop.steps"):
        return None
    counts = t["counts"]
    if "graph.replays.tail" not in counts and "graph.captures.tail" not in counts:
        return None
    return 100.0 * counts.get("graph.replays.tail", 0) / counts["loop.steps"]
