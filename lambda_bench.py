"""Times the λ kernel (B1, and B2 at R = 1) on a CUDA card, layout by layout.

    python3 lambda_bench.py [--tree DIR] [--layouts]
        [--shapes R,D,MK,cavi|cold ...] [--reps 20] [--out FILE]

For each shape of SHAPES or --shapes (R, D, MK and the solver budgets), on
chip_smoke.py's seeded SPD problems (at the CAVI budgets from its warm start
near the optimum), it prints the kernel's time as the wrapper launches
it (`launch_geometry`), its max |kernel − plain| and its bound (the larger
of the bytes over the card's memory rate and the float operations over its
float32 rate: chip_smoke.py's `lambda_bound`). With --layouts it does the
same for every layout of `_candidate_geometries(MK)`. Two times per call,
each the median over 5 runs of CUDA events around `--reps` calls, divided
by `--reps`: "eager", the calls back to back from Python, which holds the
wrapper's host time where that exceeds the kernel's; and "device", one
replay of a CUDA graph that captured the `--reps` calls, the kernels alone
back to back.

--tree DIR imports the package from DIR, an unpacked earlier commit, so the
same script times that commit's kernel (a tree without `launch_geometry`
times its wrapper alone). Each line also goes, as JSON, to --out.

Needs a CUDA card; exits with an error without one.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

import chip_smoke

# (R, D, MK, budgets): the split route's shapes at the f32 CAVI budgets
# (BRCA at R = 100 and 1000, PCAWG's MK 19, the ends of the MK ≤ 32 layouts,
# the block layout's MK 40 and 128), the single-model entry (B2) at the
# cold defaults, and R = 1 … 16 at MK 14 and 19 for the few-problem/thread
# crossover.
SHAPES = (
    (100, 560, 14, "cavi"), (1000, 560, 14, "cavi"), (100, 560, 19, "cavi"),
    (100, 560, 32, "cavi"), (100, 560, 40, "cavi"), (100, 560, 128, "cavi"),
    (1, 560, 14, "cold"),
    *((R, 560, MK, "cavi") for MK in (14, 19) for R in (1, 2, 4, 8, 16)),
)
BUDGETS = {"cavi": dict(n_iter=3, cg_iter=4, polish_iter=1), "cold": {}}
REPO = os.path.dirname(os.path.abspath(__file__))


def problem(gen, R, D, MK, warm, lk):
    """chip_smoke.py's seeded SPD problems on the card, with its warm start
    for the CAVI budgets."""
    import torch

    args = chip_smoke.spd_problem(gen, R, D, MK, "cuda")
    if warm:
        opt = lk.maximize_lambda_restarts_plain(*args)
        noise = torch.randn(R, D, MK, generator=gen, dtype=torch.float64)
        args[0] = opt + 0.05 * noise.to(device="cuda", dtype=torch.float32)
    return args


def ms_per_call(torch, fn, reps):
    """(eager, device) milliseconds per call of `fn`."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for run in (lambda: [fn() for _ in range(reps)], graph.replay):
        runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / reps)
        times.append(statistics.median(runs))
    return times


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tree", help="import the package from this directory")
    p.add_argument("--layouts", action="store_true", help="time every candidate layout")
    p.add_argument("--shapes", nargs="+", metavar="R,D,MK,BUDGETS",
                   help="time these shapes in place of SHAPES, e.g. 100,560,19,cavi")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", help="append the lines as JSON to this file")
    args = p.parse_args(argv)
    root = os.path.abspath(args.tree) if args.tree else REPO
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("lambda_bench: needs a CUDA card")
    lk = importlib.import_module("multimodalmusig_tpu_torch.ops.lambda_kernel")
    lk.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"λ kernel of {root}: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    has_layouts = hasattr(lk, "launch_geometry")
    gen = torch.Generator().manual_seed(4)
    out = open(args.out, "a") if args.out else None
    shapes = SHAPES if not args.shapes else [
        (*map(int, a.split(",")[:3]), a.split(",")[3]) for a in args.shapes]
    for R, D, MK, budget in shapes:
        kw = BUDGETS[budget]
        data = problem(gen, R, D, MK, budget == "cavi", lk)
        want = lk.maximize_lambda_restarts_plain(*data, **kw)
        cg = kw.get("cg_iter", min(MK, 10))
        bms, by = chip_smoke.lambda_bound(R, D, MK, kw.get("n_iter", 7), cg, kw.get("polish_iter", 2))
        runs = [("default", lambda: lk.maximize_lambda_restarts(*data, **kw))]
        if has_layouts:
            runs[0] = (tuple(lk.launch_geometry(R, D, MK)), runs[0][1])
            if args.layouts:
                runs += [(tuple(g), lambda g=g: lk._launch_at(g, *data, **kw))
                         for g in lk._candidate_geometries(MK) if g != lk.launch_geometry(R, D, MK)]
        for i, (geo, fn) in enumerate(runs):
            got = fn()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            eager, device = ms_per_call(torch, fn, args.reps)
            line = {"R": R, "D": D, "MK": MK, "budgets": budget, "layout": geo,
                    "picked": i == 0, "eager_ms": eager, "device_ms": device,
                    "max_abs_err": err, "bound_ms": bms, "bound_by": by,
                    "over_bound": device / bms, "card": smi}
            print(f"({R}, {D}, {MK}) {budget:4s} {str(geo):32s} {'picked' if i == 0 else '      '} "
                  f"eager {eager:.5f}, device {device:.5f} ms per call, {device / bms:6.1f}x its "
                  f"bound {bms:.6f} ms ({by}); max|kernel - plain| {err:.3e}")
            if out:
                out.write(json.dumps(line) + "\n")
    if out:
        out.close()


if __name__ == "__main__":
    main()
