"""Example: choose the number of signatures K by held-out log-likelihood.

    python -m multimodalmusig_tpu_torch.examples.select_k [--data-dir DIR]
        [--restarts N] [--samples N] [--maxiter N] [--device cuda]

Sweeps MMCTM K candidates on a train split of the BRCA-EU cohort and scores
each on the held-out samples (the reference provides fit_heldout as the
primitive; this is the usual selection loop around it). The JAX package's
examples/select_k.py, on the card unless `--device cpu`.
"""

import argparse
import os

from multimodalmusig_tpu_torch.model_selection import select_k_mmctm
from multimodalmusig_tpu_torch.utils.data import brca_data_dir
from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv
from multimodalmusig_tpu_torch.utils.formatting import make_count_matrix

CANDIDATES = [[4, 4], [7, 7], [10, 10]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=None,
                    help="counts directory (default: the bundled data/ TSVs)")
    ap.add_argument("--restarts", type=int, default=8)
    ap.add_argument("--samples", type=int, default=120)
    ap.add_argument("--maxiter", type=int, default=300)
    ap.add_argument("--heldout-maxiter", type=int, default=100)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    data_dir = brca_data_dir() if args.data_dir is None else args.data_dir

    snv, _, samples = read_counts_tsv(os.path.join(data_dir, "brca-eu_snv_counts.tsv"))
    sv, _, _ = read_counts_tsv(os.path.join(data_dir, "brca-eu_sv_counts.tsv"))
    n = min(args.samples, len(samples))
    X = [[make_count_matrix(snv[:, d]), make_count_matrix(sv[:, d])] for d in range(n)]

    best_k, curve = select_k_mmctm(
        CANDIDATES, X, [0.1, 0.1], test_fraction=0.2, restarts=args.restarts,
        maxiter=args.maxiter, heldout_maxiter=args.heldout_maxiter, verbose=True,
        device=args.device,
    )
    print("\nheld-out log-likelihood curve:")
    for k, ll in curve:
        print(f"  K={k}: {[round(v, 5) for v in ll]}")
    print(f"selected K = {best_k}")
    return best_k, curve


if __name__ == "__main__":
    main()
