"""Model selection: choose the signature counts K by held-out log-likelihood.

Counterpart of multimodalmusig_tpu/model_selection.py, with its split copied
(the same numpy `default_rng(seed)` permutation, so both packages hold out
the same documents). The reference provides the primitive (`fit_heldout`,
src/MMCTM.jl:554-586) and leaves the selection loop to the user; this module
packages it: split the samples, fit each candidate K (best-of-N through
`fit_mmctm_restarts` when restarts > 1), score it on the held-out split, and
return the curve. The fits and the held-out scoring run on `device`, the
CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .models.mmctm import MMCTM, fit_heldout
from .parallel.restarts import fit_mmctm_restarts
from .utils.formatting import infer_vocab_size

__all__ = ["train_test_split_docs", "heldout_ll_curve", "select_k_mmctm"]


def train_test_split_docs(X: Sequence, test_fraction: float = 0.2, seed: int = 0):
    """Split documents (samples) into train/test lists, in their order."""
    rng = np.random.default_rng(seed)
    D = len(X)
    n_test = max(1, int(round(D * test_fraction)))
    perm = rng.permutation(D)
    test_idx = set(perm[:n_test].tolist())
    train = [X[d] for d in range(D) if d not in test_idx]
    test = [X[d] for d in range(D) if d in test_idx]
    return train, test


def heldout_ll_curve(
    k_values: Sequence[Sequence[int]],
    X_train,
    X_test,
    alpha: Sequence[float],
    restarts: int = 10,
    maxiter: int = 500,
    heldout_maxiter: int = 100,
    seed: int = 0,
    verbose: bool = False,
    compact_schedule=None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> List[Tuple[List[int], List[float]]]:
    """For each candidate K vector, fit MMCTM on X_train (`fit_mmctm_restarts`
    with `compact_schedule` passed on when restarts > 1, else one `MMCTM`
    fit) and score the per-modality held-out log-likelihood on X_test with
    `fit_heldout`. Returns [(K, held-out ll per modality), ...]."""
    # the vocabulary is sized over both splits: a term seen only in held-out
    # documents still needs its row in the trained topics
    M = len(X_train[0])
    V = [
        max(infer_vocab_size([doc[m] for doc in X_train]),
            infer_vocab_size([doc[m] for doc in X_test]))
        for m in range(M)
    ]
    curve = []
    for k in k_values:
        k = list(k)
        if restarts > 1:
            model = fit_mmctm_restarts(k, list(alpha), X_train, V=V, restarts=restarts,
                                       maxiter=maxiter, seed=seed, dtype=dtype,
                                       compact_schedule=compact_schedule, device=device)
        else:
            model = MMCTM(k, list(alpha), V, X_train, seed=seed, dtype=dtype, device=device)
            model.fit(maxiter=maxiter, verbose=False)
        heldout = fit_heldout(X_test, model, maxiter=heldout_maxiter)
        curve.append((k, [float(v) for v in heldout.ll]))
        if verbose:
            print(f"K={k}: heldout ll = {curve[-1][1]}")
    return curve


def select_k_mmctm(k_values: Sequence[Sequence[int]], X, alpha: Sequence[float],
                   test_fraction: float = 0.2, device="cuda", **kwargs):
    """Split, sweep K on `device` (the CUDA card unless the caller asks for
    the CPU), and pick the candidate with the best mean held-out
    log-likelihood. `kwargs` are heldout_ll_curve's. Returns (best_k,
    curve)."""
    X_train, X_test = train_test_split_docs(X, test_fraction, kwargs.get("seed", 0))
    curve = heldout_ll_curve(k_values, X_train, X_test, alpha, device=device, **kwargs)
    best_k, _ = max(curve, key=lambda kv: float(np.mean(kv[1])))
    return best_k, curve
