"""Example: the reference README's workflow on the BRCA-EU cohort, every
model family and the production multi-restart protocol, on the card unless
`--device cpu`:

    python -m multimodalmusig_tpu_torch.examples.fit_brca [--data-dir DIR]
        [--restarts N] [--maxiter N] [--device cuda] [--model PATH]

(The JAX package's examples/fit_brca.py; README.md:20-84 of the reference
shows the Julia equivalents.)
"""

import argparse
import os
import re

import numpy as np

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.utils.data import brca_data_dir
from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv
from multimodalmusig_tpu_torch.utils.formatting import make_count_matrix


def snv_features(terms):
    """Factorize SNV terms like 'A[C->A]A' into (substitution, 5', 3')."""
    subs, fives, threes, rows = {}, {}, {}, []
    for t in terms:
        f5, ref, alt, f3 = re.match(r"(\w)\[(\w)->(\w)\](\w)", t).groups()
        rows.append([subs.setdefault(f"{ref}>{alt}", len(subs) + 1),
                     fives.setdefault(f5, len(fives) + 1),
                     threes.setdefault(f3, len(threes) + 1)])
    return np.asarray(rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=None,
                    help="counts directory (default: the bundled data/ TSVs)")
    ap.add_argument("--restarts", type=int, default=20)
    ap.add_argument("--maxiter", type=int, default=300, help="CAVI iterations per fit, at most")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--model", default=None, help="write the MMCTM checkpoint here (.npz)")
    args = ap.parse_args(argv)
    data_dir = brca_data_dir() if args.data_dir is None else args.data_dir

    snv, snv_terms, samples = read_counts_tsv(os.path.join(data_dir, "brca-eu_snv_counts.tsv"))
    sv, _, _ = read_counts_tsv(os.path.join(data_dir, "brca-eu_sv_counts.tsv"))
    print(f"{len(samples)} samples; SNV {snv.shape[0]} terms, SV {sv.shape[0]} terms")
    X_lda = [make_count_matrix(snv[:, d]) for d in range(len(samples))]
    X_mm = [[make_count_matrix(snv[:, d]), make_count_matrix(sv[:, d])]
            for d in range(len(samples))]
    kw = dict(maxiter=args.maxiter, device=args.device)

    # LDA, best of N restarts (README.md:75-84 of the reference)
    lda = mt.fit_lda_restarts(7, 0.1, 0.1, X_lda, restarts=args.restarts, **kw)
    print(f"LDA(7): ll={lda.ll:.5f} elbo={lda.elbo:.0f} converged={lda.converged}")

    # ILDA with the SNV terms factored into substitution, 5' and 3' bases
    ilda = mt.fit_ilda_restarts(7, 0.1, 0.1, snv_features(snv_terms), X_lda,
                                restarts=max(args.restarts // 2, 2), **kw)
    print(f"ILDA(7): ll={ilda.ll:.5f}")

    # CTM = single-modality MMCTM (README.md:67-73)
    ctm = mt.CTM(7, 0.1, [[doc[0]] for doc in X_mm], device=args.device)
    ctm.fit(maxiter=args.maxiter, verbose=False)
    print(f"CTM(7): ll={ctm.ll}")

    # the flagship MMCTM with the reference CLI's two-stage restart protocol
    model = mt.fit_mmctm_restarts([7, 7], [0.1, 0.1], X_mm, restarts=args.restarts, **kw)
    print(f"MMCTM([7,7]): ll={model.ll} elbo={model.elbo:.0f}")

    # cross-modality signature correlation (the model's headline output)
    Sigma = model.Sigma
    corr = Sigma / np.sqrt(np.outer(np.diag(Sigma), np.diag(Sigma)))
    i, j = np.unravel_index(np.abs(corr[:7, 7:]).argmax(), (7, 7))
    print(f"strongest SNV<->SV signature correlation: SNV-{i + 1} x SV-{j + 1} "
          f"= {corr[i, 7 + j]:.3f}")

    # predict SV activity from the SNV counts alone for the first 5 samples
    eta = mt.predict_modality_eta([[doc[0]] for doc in X_mm[:5]], 2, model, maxiter=50)
    print("predicted SV eta, sample 1:", np.round(eta[0], 2))

    if args.model is not None:
        mt.save_model(args.model, model)
        print(f"checkpoint written to {args.model}")
    return {"lda": lda, "ilda": ilda, "ctm": ctm, "mmctm": model, "eta": eta}


if __name__ == "__main__":
    main()
