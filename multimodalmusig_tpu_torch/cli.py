"""run-mmctm-torch: best-of-N MMCTM fitting on mutation count TSVs, on a
CUDA card.

Counterpart of multimodalmusig_tpu/cli.py (the reference's
scripts/run_mmctm.jl: its arguments at :15-71, the two-stage fit at
:163-180, the outputs at :272-290), with the same flags, defaults,
messages and exit codes, but for `--device {cuda,cpu}` (default cuda) in
place of the JAX package's `--platform`. Without a card, `--device cuda`
exits with an error; it never falls back to the CPU.

Usage:
    python -m multimodalmusig_tpu_torch.cli snv.tsv sv.tsv -k 7 7 \\
        -m SNV SV --restarts 1000 --auto-compact --sigs sigs.tsv --props props.tsv

Input TSVs: column 1 = `term`, the other columns = samples (the bundled
BRCA-EU format, data/brca-eu_*_counts.tsv). Samples are matched across the
files by name, in the order of the first file.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="run-mmctm-torch",
        description="Fit a multi-modal correlated topic model (MMCTM) to "
        "mutation count matrices with multi-restart model selection, on a "
        "CUDA card.",
    )
    # inputs (run_mmctm.jl:19-30)
    p.add_argument("counts", nargs="+", help="mutation counts tsv files (one per modality)")
    p.add_argument(
        "-k", "--num-sigs", dest="k", type=int, nargs="+", required=True,
        help="number of signatures for each mutation type",
    )
    p.add_argument(
        "-m", "--modality-labels", dest="modalities", nargs="+", required=True,
        help="modality labels for output",
    )
    # outputs (run_mmctm.jl:32-44)
    p.add_argument("--model", help="model checkpoint output (.npz)")
    p.add_argument("--mean", help="gaussian mean output tsv file")
    p.add_argument("--cov", help="gaussian covariance matrix output tsv file")
    p.add_argument("--cor", help="correlation output tsv file")
    p.add_argument("--sigs", help="signatures output tsv file")
    p.add_argument("--props", help="signature proportions output tsv file")
    # options (run_mmctm.jl:46-70)
    p.add_argument(
        "--restarts", "-r", type=int, default=1000,
        help="number of restarts for the first fitting stage (default 1000)",
    )
    p.add_argument(
        "--stage2-restarts", type=int, default=1,
        help="stage-2 restarts; the reference's stage-2 restarts are "
        "deterministic duplicates, so 1 reproduces its result (default 1)",
    )
    p.add_argument("--verbose", "-v", action="store_true", help="print output")
    p.add_argument(
        "--progress", "-p", action="store_true",
        help="print the number of finished restarts at each boundary of "
        "--chunk-iters, --compact-at or --auto-compact; without them each "
        "stage runs to its end with no boundary, and is reported once, when "
        "it ends",
    )
    p.add_argument("--seed", "-s", type=int, default=147959412, help="random state seed")
    p.add_argument(
        "--alpha", "-a", type=float, default=0.1,
        help="topic dirichlet hyperparameter value",
    )
    p.add_argument("--maxiter", type=int, default=1000, help="max CAVI iterations per fit")
    p.add_argument(
        "--chunk-iters", type=int, default=0,
        help="a boundary every this many CAVI iterations in both stages, where "
        "finished restarts leave the batch and --progress reports (0 = "
        "unchunked, the default: a boundary costs a round trip to the host)",
    )
    p.add_argument(
        "--compact-at", type=int, nargs="+", default=None, metavar="ITER",
        help="straggler compaction for stage 1: run every restart the given "
        "iteration budget(s), take the finished restarts out of the batch "
        "after each, then finish the survivors unbounded. At large "
        "--restarts this avoids paying the slowest restart's iteration "
        "count on every restart. Prefer --auto-compact, which derives these "
        "budgets from a pilot fit; this flag pins explicit budgets (e.g. from "
        "a recorded suggest_compact_schedule run). Mutually exclusive with "
        "--chunk-iters.",
    )
    p.add_argument(
        "--auto-compact", action="store_true",
        help="derive the stage-1 straggler-compaction schedule automatically: "
        "the first --pilot-restarts restarts run unbounded and timed as the "
        "pilot, this device's boundary cost is measured, and the exact-DP "
        "scheduler places the boundaries for the other restarts; zero-config "
        "at --restarts 1000, matching the reference CLI's ergonomics. "
        "Mutually exclusive with --compact-at and --chunk-iters.",
    )
    p.add_argument(
        "--pilot-restarts", type=int, default=64,
        help="pilot size for --auto-compact (default 64)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the fits run: 'cuda' (the default) needs a CUDA card and "
        "fails without one; 'cpu' runs the plain PyTorch versions on the CPU",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.chunk_iters and args.compact_at:
        print(
            "run-mmctm: --chunk-iters and --compact-at are mutually exclusive "
            "(fixed-cadence chunking vs 2-phase straggler compaction)",
            file=sys.stderr,
        )
        return 1
    if args.auto_compact and (args.chunk_iters or args.compact_at):
        print(
            "run-mmctm: --auto-compact is mutually exclusive with "
            "--compact-at and --chunk-iters",
            file=sys.stderr,
        )
        return 1
    if len(args.counts) != len(args.k):
        print("Number of count files must match the number of K values.", file=sys.stderr)
        return 1
    if len(args.modalities) != len(args.k):
        print("Number of modality labels must match the number of K values.", file=sys.stderr)
        return 1

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(
            "run-mmctm: no CUDA card is available; pass --device cpu to run on "
            "the CPU",
            file=sys.stderr,
        )
        return 1

    from .utils import profiling

    with profiling.entry():
        return _fit_and_write(args)


def _read_inputs(args):
    """(sample names, each file's terms, X[doc][modality] in the reference's
    sparse (index, count) form, V) from the TSVs; None, after the message,
    when a file lacks a sample of the first."""
    from .utils.fast_tsv import read_counts_tsv
    from .utils.formatting import make_count_matrix

    loaded = [read_counts_tsv(f) for f in args.counts]  # (counts (V, D), terms, samples)
    samples = loaded[0][2]
    terms = [t for _, t, _ in loaded]
    # Align columns by sample NAME across modality files (the reference picks
    # columns by sample id from file 1's header, run_mmctm.jl:258-260, so
    # differently ordered exports must not silently misalign documents).
    col_of = []
    for path, (_, _, s) in zip(args.counts, loaded):
        index = {name: i for i, name in enumerate(s)}
        missing = [name for name in samples if name not in index]
        if missing:
            print(
                f"{path}: missing sample columns {missing[:5]}"
                f"{'...' if len(missing) > 5 else ''}",
                file=sys.stderr,
            )
            return None
        col_of.append(index)
    counts = [
        [make_count_matrix(loaded[m][0][:, col_of[m][name]]) for m in range(len(loaded))]
        for name in samples
    ]
    return samples, terms, counts, [mat.shape[0] for mat, _, _ in loaded]


def _fit_and_write(args) -> int:
    """`main` past its checks: read the TSVs, fit, write the outputs. The
    tracer's spans `cli.read` and `cli.write` cover the first and the last."""
    from .parallel.restarts import fit_mmctm_restarts
    from .utils import io as io_mod
    from .utils import profiling

    with profiling.span("cli.read"):
        inputs = _read_inputs(args)
    if inputs is None:
        return 1
    samples, terms, counts, V = inputs
    alpha = [args.alpha] * len(args.k)

    # The analogue of the reference's restart progress bar
    # (run_mmctm.jl:101-104): the fit calls it at each boundary, and once
    # when a stage ends.
    progress = None
    if args.progress:
        if not (args.chunk_iters or args.compact_at or args.auto_compact):
            print(
                "run-mmctm: --progress without --chunk-iters, --compact-at or "
                "--auto-compact: each stage runs to its end with no boundary, "
                "so each is reported once, when it ends",
                file=sys.stderr,
            )

        def progress(stage, done, total):
            # "completed", not "converged": a restart that reaches maxiter
            # without converging has finished too
            print(f"run-mmctm: stage {stage}: {done}/{total} restarts completed",
                  file=sys.stderr)

    model = fit_mmctm_restarts(
        args.k,
        alpha,
        counts,
        V=V,
        restarts=args.restarts,
        stage2_restarts=args.stage2_restarts,
        maxiter=args.maxiter,
        seed=args.seed,
        verbose=args.verbose,
        chunk_iters=args.chunk_iters or None,
        compact_schedule=(
            "auto" if args.auto_compact
            else tuple(args.compact_at) if args.compact_at else None
        ),
        pilot_restarts=args.pilot_restarts,
        progress=progress,
        device=args.device,
    )
    if args.auto_compact and getattr(model, "compact_info", None) is not None:
        info = model.compact_info
        print(
            f"run-mmctm: auto-compact schedule {info['schedule']} "
            f"(boundary {info['boundary_s'] * 1e3:.3f} ms = "
            f"{info['boundary_cost_lane_iters']:.0f} lane-iters; pilot "
            f"R={info['pilot_restarts']}, median "
            f"{info['pilot_iters_median']:.0f} iters)",
            file=sys.stderr,
        )
    if args.verbose:
        print(f"Log-likelihoods: {model.ll}")

    with profiling.span("cli.write"):
        if args.model:
            io_mod.save_model(args.model, model)
        if args.mean:
            io_mod.write_mean(args.mean, model)
        if args.cov:
            io_mod.write_cov(args.cov, model)
        if args.cor:
            io_mod.write_cor(args.cor, model)
        if args.sigs:
            io_mod.write_sigs(args.sigs, model, terms, args.modalities)
        if args.props:
            io_mod.write_props(args.props, model, samples, args.modalities)
    return 0


if __name__ == "__main__":
    sys.exit(main())
