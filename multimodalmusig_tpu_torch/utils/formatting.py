"""Count-data formatting API, mirroring the reference's src/utils.jl.

A NumPy-only copy of multimodalmusig_tpu/utils/formatting.py, so the
PyTorch package imports without JAX (tests/test_torch_package.py pins the
two copies to equal output).

The reference represents each document x modality as an (n, 2) integer matrix
of (vocab_index, count) rows with 1-based vocab indices (src/utils.jl:1-7).
That sparse ragged form is kept at the I/O boundary for API parity, but the
compute path uses dense (D, V) count tensors: at V = 96/48 terms a dense
row is smaller than the ragged bookkeeping and every update becomes a
batched matmul.

`format_counts_lda/ctm/mmctm` accept pandas DataFrames shaped exactly like
the reference's inputs (rows = vocabulary terms, columns = samples;
src/utils.jl:9-36).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

__all__ = [
    "make_count_matrix",
    "format_counts_lda",
    "format_counts_ctm",
    "format_counts_mmctm",
    "sparse_to_dense",
    "dense_to_sparse",
    "infer_vocab_size",
]


def make_count_matrix(counts) -> np.ndarray:
    """Dense count column -> (n, 2) matrix of 1-based (index, count) rows.

    Drops zero counts, exactly like src/utils.jl:1-7.
    """
    counts = np.asarray(counts)
    idx = np.nonzero(counts > 0)[0]
    return np.stack([idx + 1, counts[idx]], axis=1).astype(np.int64)


def format_counts_lda(countsdf, cols: Sequence) -> List[np.ndarray]:
    """DataFrame -> per-sample (n, 2) count matrices (src/utils.jl:9-18)."""
    return [make_count_matrix(np.asarray(countsdf[col])) for col in cols]


def format_counts_ctm(countsdf, cols: Sequence) -> List[List[np.ndarray]]:
    """Single-modality wrapper around format_counts_mmctm (src/utils.jl:20-22)."""
    return format_counts_mmctm([countsdf], cols)


def format_counts_mmctm(countdfs: Sequence, cols: Sequence) -> List[List[np.ndarray]]:
    """DataFrames (one per modality) -> X[doc][modality] (src/utils.jl:24-36)."""
    return [
        [make_count_matrix(np.asarray(df[col])) for df in countdfs]
        for col in cols
    ]


def infer_vocab_size(X: Sequence[np.ndarray]) -> int:
    """V = max 1-based vocab index across documents (src/LDA.jl:57-67)."""
    V = 0
    for doc in X:
        doc = np.asarray(doc)
        if doc.shape[0] > 0:
            V = max(V, int(doc[:, 0].max()))
    return V


def sparse_to_dense(X: Sequence[np.ndarray], V: int, dtype=np.float64) -> np.ndarray:
    """Ragged (n, 2) 1-based (index, count) docs -> dense (D, V) count matrix."""
    D = len(X)
    dense = np.zeros((D, V), dtype=dtype)
    for d, doc in enumerate(X):
        doc = np.asarray(doc)
        if doc.shape[0] > 0:
            idx = doc[:, 0].astype(np.int64)
            if idx.min() < 1 or idx.max() > V:
                raise ValueError(
                    f"document {d}: vocab indices must be in 1..{V} "
                    f"(got {int(idx.min())}..{int(idx.max())}); indices are "
                    "1-based as in the reference format"
                )
            np.add.at(dense[d], idx - 1, doc[:, 1])
    return dense


def dense_to_sparse(dense: np.ndarray) -> List[np.ndarray]:
    """Dense (D, V) counts -> list of (n, 2) 1-based (index, count) docs."""
    return [make_count_matrix(row) for row in np.asarray(dense)]
