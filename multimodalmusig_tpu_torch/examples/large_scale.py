"""Example: a large restart fleet, compacted with a pilot-derived schedule
on one device, or fanned out over several.

The production workflow at the reference CLI's default scale (1000
restarts, run_mmctm.jl:52) and beyond:

1. a pilot fit measures this dataset's iterations to convergence at this
   tol, this device's lane-iterations per second and its boundary cost
   (`auto_compact_schedule`; the CLI's --auto-compact runs the same);
2. `suggest_compact_schedule` turns them into compaction boundaries by
   exact dynamic programming;
3. the fleet runs with `compact_schedule=...`: finished lanes leave the
   batch instead of idling until the slowest lane ends.

With `--devices` the fleet runs instead as the restart fan-out of
parallel/sharding.py (`shmap_fit_restarts`), one process per listed
device, each fitting its slice of the lanes uncut (compaction is a
single-process schedule); a device may be listed twice to run two ranks on
one card.

    python -m multimodalmusig_tpu_torch.examples.large_scale [--restarts N]
        [--pilot N] [--tol TOL] [--maxiter N] [--device cuda]
        [--devices cuda:0 cuda:1 ...]
"""

import argparse
import os
import time

import numpy as np

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.parallel.sharding import shmap_fit_restarts
from multimodalmusig_tpu_torch.utils.data import brca_data_dir
from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=None,
                    help="counts directory (default: the bundled data/ TSVs)")
    ap.add_argument("--restarts", type=int, default=1000)
    ap.add_argument("--pilot", type=int, default=64)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--maxiter", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--devices", nargs="+", default=None,
                    help="fan the fleet out over these devices, one process each")
    args = ap.parse_args(argv)
    data_dir = brca_data_dir() if args.data_dir is None else args.data_dir

    X = [read_counts_tsv(os.path.join(data_dir, f))[0].T
         for f in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")]  # (D, V) each
    config = mt.MMCTMConfig(K=(7, 7), V=tuple(x.shape[1] for x in X), D=X[0].shape[0])
    alpha = [0.1, 0.1]
    kw = dict(restarts=args.restarts, maxiter=args.maxiter, tol=args.tol)

    t0 = time.perf_counter()
    if args.devices is None:
        # 1+2. the pilot and the derivation in one call
        schedule, info = mt.auto_compact_schedule(args.seed, X, config, alpha,
                                                  pilot_restarts=args.pilot,
                                                  device=args.device, **kw)
        print(f"pilot: {info['pilot_restarts']} restarts "
              f"(p50={info['pilot_iters_median']:.0f} iters, "
              f"{info['lane_iters_per_s']:.0f} lane-iters/s) in "
              f"{time.perf_counter() - t0:.2f} s")
        print(f"suggested compact_schedule: {schedule} (boundary "
              f"{info['boundary_s'] * 1e3:.3f} ms = {info['boundary_cost_lane_iters']:.0f} "
              f"lane-iters)")
        # 3. the production fleet; () means no boundary pays: unchunked
        t0 = time.perf_counter()
        result = mt.fit_restarts(args.seed, X, config, alpha, compact_schedule=schedule,
                                 device=args.device, **kw)
    else:
        run_info = {}
        result = shmap_fit_restarts(args.seed, X, config, alpha, devices=args.devices,
                                    run_info=run_info, **kw)
        print(f"fan-out over {args.devices} ({run_info['backend']}, "
              f"{run_info['ranks_per_device']} ranks per device): start-up "
              f"{run_info['startup_s']:.2f} s, fit {run_info['fit_s']:.2f} s")
    ll = result.ll.detach().cpu().double().numpy()
    t = time.perf_counter() - t0
    best = mt.pick_optimal_modality_restarts(result.ll).cpu().numpy()
    print(f"fleet: {args.restarts} restarts in {t:.2f} s ({args.restarts / t:.1f} restarts/s), "
          f"{int(np.isfinite(ll).all(axis=1).sum())}/{args.restarts} lanes finite")
    print(f"per-modality best ll: {[float(ll[best[m], m]) for m in range(2)]}")
    return result


if __name__ == "__main__":
    main()
