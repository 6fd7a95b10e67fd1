"""Times the λ kernel (B1, and B2 at R = 1), the η kernel (B3) or the θ
kernel (B4) on a CUDA card, layout by layout.

    python3 lambda_bench.py [--eta | --theta] [--tree DIR] [--layouts]
        [--shapes R,D,MK,cavi|cold ... | --eta --shapes R,D,K1+K2+...,cavi|cold ...
         | --theta --shapes R,D,V,K ... | --eta --crossovers]
        [--reps 20] [--out FILE]

For each shape of SHAPES (with --eta ETA_SHAPES, with --crossovers
CROSSOVER_SHAPES) or --shapes (R, D, MK or
the topic counts K, and the solver budgets), on chip_smoke.py's seeded
problems (λ: its SPD problems, at the CAVI budgets from its warm start near
the optimum; η: `eta_problem`), it prints the kernel's time as the wrapper
launches it (`launch_geometry`), its max |kernel − plain| and its bound
(the larger of the bytes over the card's memory rate and the float
operations over its float32 rate: chip_smoke.py's `lambda_bound` and
`eta_bound`); with --eta also the plain version's time (CUDA events around
eager calls). With --theta it times B4 at THETA_SHAPES on chip_smoke.py's
`theta_problem` inputs, with the plain version's time, its bound
(`theta_bound`) and, as the yardstick a hand-written kernel must beat, the
factorized schedule (`ctm_base.theta_moments_one`'s "factorized" route:
three batched cuBLAS matmuls, TF32 off), timed as the kernel is. With
--layouts it does the same for every layout of
`_candidate_geometries(MK)`, each launched through the module's private
`_launch_at`. Two times per call, each the median over 5 runs of CUDA
events around `--reps` calls, divided by `--reps`: "eager", the calls back
to back from Python, which holds the wrapper's host time where that
exceeds the kernel's; and "device", one replay of a CUDA graph that
captured the `--reps` calls, the kernels alone back to back.

--tree DIR imports the package from DIR, an unpacked earlier commit, so the
same script times that commit's kernel (a tree without `_launch_at` times
its wrapper alone, in the layout its own `launch_geometry` picks). Each
line also goes, as JSON, to --out.

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
# (R, D, K, budgets) of the η kernel, all at the f32 CAVI budgets: K
# selection's (9, 9) at R = 100 by the 448 training documents, PCAWG's
# K = (7, 7, 5) (tools/pcawg_bench.py:27) at R = 100 and 1000 by D = 2800,
# MK 16 to 32 at R = 100 by D = 560 for the pair/thread ranges; the calls
# of few problems: R = 1 at D = 560 (stage 2, MMCTM.fit), 448 and 112
# (inference), 280 (a data rank) and 2800 (PCAWG), and R = 1 … 32 at
# D = 560 for the few-problem crossovers at MK 14, 19 and 32; the BRCA
# main path, (100, 560, (7, 7)) and (1000, 560, (7, 7)); then MK 33–128:
# MK 33 to 128 at R = 100 by D = 560 (and MK 32, 33 either side of the
# boundary), three modalities (20, 12, 8) at PCAWG's D = 2800, K = (20, 20)
# at R = 1000, R = 1 at D = 112, 448, 560 and 2800, and R = 2 … 32 at
# D = 560 for the few-problem crossover at MK 40 and 128, and at MK 65 R = 1
# at D = 112, 448 and 560 (split8 at P = 10 against BlockGroup<128>).
ETA_SHAPES = (
    (100, 448, (9, 9)), (100, 2800, (7, 7, 5)), (1000, 2800, (7, 7, 5)),
    *((100, 560, K) for K in ((8, 8), (9, 8), (10, 9), (10, 10), (11, 10), (11, 11), (12, 12),
                              (13, 12), (13, 13), (14, 14), (15, 14), (15, 15), (16, 16))),
    *((1, D, (7, 7)) for D in (560, 448, 112, 280, 2800)),
    (1, 112, (9, 9)), (1, 2800, (7, 7, 5)),
    *((R, 560, K) for K in ((7, 7), (7, 7, 5), (16, 16)) for R in (2, 3, 4, 6, 8, 12, 16, 32)),
    (1, 560, (7, 7, 5)), (1, 560, (16, 16)),
    (100, 560, (7, 7)), (1000, 560, (7, 7)),
    *((100, 560, K) for K in ((17, 16), (20, 20), (24, 24), (32, 32), (33, 32), (48, 48),
                              (64, 64))),
    (100, 2800, (20, 12, 8)), (1000, 560, (20, 20)),
    *((1, D, K) for K in ((20, 20), (64, 64)) for D in (112, 448, 560, 2800)),
    *((R, 560, K) for K in ((20, 20), (64, 64)) for R in (2, 4, 8, 16, 32)),
    *((1, D, (33, 32)) for D in (112, 448, 560)),
)
# (R, D, K) of --crossovers, at the CAVI budgets: above MK 32, where the
# block layout gives way to split4 or split8 (`BLOCK_MAX_PROBLEMS`), at
# each P of the split layouts by R·D from 560 to 5,600.
CROSSOVER_SHAPES = tuple(
    (R, D, K) for K in ((20, 20), (24, 24), (28, 28), (32, 32), (33, 32), (40, 40), (48, 48),
                        (56, 56), (64, 64))
    for R, D in ((1, 560), (1, 840), (1, 1120), (2, 560), (1, 1680), (3, 560), (1, 2240),
                 (4, 560), (1, 2800), (1, 3360), (6, 560), (1, 4480), (8, 560), (1, 5600)))
# (R, D, V, K) of --theta: the BRCA vocabularies (V = 96 and 48) at R = 100
# by D = 560 for K 7–128 (either side of the power-of-two and multiple-of-8
# paddings), K = 20 at R = 1000 and at PCAWG's D = 2800, K selection's
# (9, 9) on the 448 training documents, R = 1 (stage 2, inference) and the
# small restart batches R = 8 and 32.
THETA_SHAPES = (
    *((100, 560, V, K) for V in (96, 48)
      for K in (7, 9, 12, 16, 20, 24, 32, 33, 40, 48, 64, 65, 96, 128)),
    (1000, 560, 96, 20), (100, 2800, 96, 20), (100, 448, 48, 9),
    (1, 560, 96, 20), (1, 560, 96, 64), (8, 560, 96, 20), (32, 560, 96, 64),
)
ETA_BUDGETS = {"cavi": dict(n_iter=3, cg_iter=4, polish_iter=1, nu_n_iter=4), "cold": {}}
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


def eager_ms(torch, fn, reps):
    """Median milliseconds of `fn()` by CUDA events around single calls."""
    fn()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return statistics.median(runs)


def lambda_runs(torch, lk, gen, shape, layouts):
    """B1 at one (R, D, MK, budgets): (label fields, bound, plain ms, runs)."""
    R, D, MK, budget = shape
    kw = BUDGETS[budget]
    data = problem(gen, R, D, MK, budget == "cavi", lk)
    want = lk.maximize_lambda_restarts_plain(*data, **kw)
    cg = kw.get("cg_iter", min(MK, 10))
    bnd = chip_smoke.lambda_bound(R, D, MK, kw.get("n_iter", 7), cg, kw.get("polish_iter", 2))
    runs = [("default", lambda: lk.maximize_lambda_restarts(*data, **kw))]
    if hasattr(lk, "launch_geometry"):
        runs[0] = (tuple(lk.launch_geometry(R, D, MK)), runs[0][1])
        if layouts:
            runs += [(tuple(g), lambda g=g: lk._launch_at(g, *data, **kw))
                     for g in lk._candidate_geometries(MK) if g != lk.launch_geometry(R, D, MK)]
    err = lambda got: float((got - want).abs().max())  # noqa: E731
    return {"R": R, "D": D, "MK": MK, "budgets": budget}, bnd, None, runs, err


def eta_runs(torch, ek, gen, shape, layouts):
    """B3 at one (R, D, K, budgets): (label fields, bound, plain ms, runs)."""
    R, D, K, budget = shape
    MK = sum(K)
    kw = ETA_BUDGETS[budget]
    data = chip_smoke.eta_problem(gen, R, D, K)
    want = ek.estep_eta_fused_plain(*data, K, **kw)
    plain_ms = eager_ms(torch, lambda: ek.estep_eta_fused_plain(*data, K, **kw), 5)
    steps = (3, 4, 1, 4) if budget == "cavi" else (7, min(MK, 10), 2, 8)
    bnd = chip_smoke.eta_bound(R, D, K, *steps)
    default = lambda: ek.estep_eta_fused(*data, K, **kw)  # noqa: E731
    if hasattr(ek, "_launch_at"):
        picked = ek.launch_geometry(R, D, MK)
        runs = [(tuple(picked), default)]
        if layouts:
            runs += [(tuple(g), lambda g=g: ek._launch_at(g, *data, K, **kw))
                     for g in ek._candidate_geometries(MK) if g != picked]
    else:  # an earlier tree: the layout its launch_geometry(MK) picks
        runs = [(tuple(ek.launch_geometry(MK)), default)]
    err = lambda got: max(float((g - w).abs().max()) for g, w in zip(got, want))  # noqa: E731
    return {"R": R, "D": D, "K": list(K), "MK": MK, "budgets": budget}, bnd, plain_ms, runs, err


def theta_runs(torch, tk, gen, shape, layouts):
    """B4 at one (R, D, V, K): (label fields, bound, plain ms, runs), the
    factorized schedule's run last, labelled "factorized"."""
    from multimodalmusig_tpu_torch.models import ctm_base

    R, D, V, K = shape
    data = chip_smoke.theta_problem(gen, R, D, V, K)
    want = tk.theta_moments_fused_plain(*data)
    plain_ms = eager_ms(torch, lambda: tk.theta_moments_fused_plain(*data), 5)
    bnd = chip_smoke.theta_bound(R, D, V, K)
    default = lambda: tk.theta_moments_fused(*data)  # noqa: E731
    if hasattr(tk, "_launch_at"):
        picked = tk.launch_geometry(R, D, V, K)
        runs = [(tuple(picked), default)]
        if layouts:
            runs += [(tuple(g), lambda g=g: tk._launch_at(g, *data))
                     for g in tk._candidate_geometries(R, D, V, K) if g != picked]
    else:  # an earlier tree: the geometry its launch_geometry picks
        runs = [(tuple(tk.launch_geometry(R, D, V, K)), default)]

    def factorized():
        route = ctm_base._theta_route
        ctm_base._theta_route = lambda *a: "factorized"
        try:
            with ctm_base.full_f32_matmuls():
                return ctm_base.theta_moments_one(*data)
        finally:
            ctm_base._theta_route = route

    runs.append(("factorized", factorized))
    err = lambda got: max(float((g - w).abs().max()) for g, w in zip(got, want))  # noqa: E731
    return {"R": R, "D": D, "V": V, "K": K}, bnd, plain_ms, runs, err


def parse_shape(text, eta):
    if eta == "theta":
        return tuple(int(a) for a in text.split(","))
    R, D, mk, budget = text.split(",")
    return (int(R), int(D), tuple(int(k) for k in mk.split("+")) if eta else int(mk), budget)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--eta", action="store_true", help="time the η kernel (B3)")
    p.add_argument("--theta", action="store_true", help="time the θ kernel (B4)")
    p.add_argument("--tree", help="import the package from this directory")
    p.add_argument("--layouts", action="store_true", help="time every candidate layout")
    p.add_argument("--crossovers", action="store_true",
                   help="with --eta: time CROSSOVER_SHAPES in place of ETA_SHAPES")
    p.add_argument("--shapes", nargs="+", metavar="R,D,MK,BUDGETS",
                   help="time these shapes in place of SHAPES, e.g. 100,560,19,cavi "
                   "(with --eta: 100,560,7+7,cavi)")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--out", help="append the lines as JSON to this file")
    args = p.parse_args(argv)
    root = os.path.abspath(args.tree) if args.tree else REPO
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("lambda_bench: needs a CUDA card")
    mode = "theta" if args.theta else "eta" if args.eta else ""
    module = {"theta": "theta_kernel", "eta": "estep_kernel", "": "lambda_kernel"}[mode]
    kernel = importlib.import_module(f"multimodalmusig_tpu_torch.ops.{module}")
    kernel.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name = {"theta": "θ", "eta": "η", "": "λ"}[mode]
    print(f"{name} kernel of {root}: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    gen = torch.Generator().manual_seed(4)
    out = open(args.out, "a") if args.out else None
    if args.shapes:
        shapes = [parse_shape(a, mode) for a in args.shapes]
    elif mode == "theta":
        shapes = THETA_SHAPES
    else:
        eta_shapes = CROSSOVER_SHAPES if args.crossovers else ETA_SHAPES
        shapes = [(*s, "cavi") for s in eta_shapes] if args.eta else SHAPES
    runner = {"theta": theta_runs, "eta": eta_runs, "": lambda_runs}[mode]
    for shape in shapes:
        fields, (bms, by), plain_ms, runs, error = runner(torch, kernel, gen, shape, args.layouts)
        for i, (geo, fn) in enumerate(runs):
            got = fn()
            torch.cuda.synchronize()
            err = error(got)
            eager, device = ms_per_call(torch, fn, args.reps)
            line = {**fields, "layout": geo, "picked": i == 0, "eager_ms": eager,
                    "device_ms": device, "plain_ms": plain_ms, "max_abs_err": err,
                    "bound_ms": bms, "bound_by": by, "over_bound": device / bms, "card": smi,
                    "tree": root}
            plain = f", plain {plain_ms:.4f} ms" if plain_ms is not None and i == 0 else ""
            label = shape if mode == "theta" else f"{shape[:3]} {shape[3]:4s}"
            print(f"{label} {str(geo):32s} {'picked' if i == 0 else '      '} "
                  f"eager {eager:.5f}, device {device:.5f} ms per call, {device / bms:6.1f}x its "
                  f"bound {bms:.6f} ms ({by}){plain}; max|kernel - plain| {err:.3e}", flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
    if out:
        out.close()


if __name__ == "__main__":
    main()
