"""Count-data formatting API, mirroring the reference's src/utils.jl.

A NumPy-only port of multimodalmusig_tpu/utils/formatting.py, so the
PyTorch package imports without JAX. Its functions give the JAX package's
output: `sparse_to_dense` builds the dense counts with one vectorized
scatter where the JAX package loops over documents, with the same bits and
errors (tests/test_torch_formatting.py and tests/test_torch_package.py pin
both).

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
    """Ragged (n, 2) 1-based (index, count) docs -> dense (D, V) count matrix.

    One scatter over every document's entries, each entry at its flat cell
    row * V + index - 1: for float64 `np.bincount`, which sums each cell's
    entries in input order as `np.add.at` does (so duplicates give the same
    bits), for any other dtype one `np.add.at` in that dtype. Empty
    documents ((0, 2), (0,) or []) stay zero rows."""
    D = len(X)
    docs = [np.asarray(doc) for doc in X]
    lengths = np.fromiter((doc.shape[0] for doc in docs), np.int64, D)
    if not lengths.any():
        return np.zeros((D, V), dtype=dtype)
    entries = np.concatenate([doc for doc, n in zip(docs, lengths) if n > 0])
    idx = entries[:, 0].astype(np.int64)
    row = np.repeat(np.arange(D), lengths)
    bad = (idx < 1) | (idx > V)
    if bad.any():
        d = int(row[bad.argmax()])
        start = int(lengths[:d].sum())
        doc_idx = idx[start:start + lengths[d]]
        raise ValueError(
            f"document {d}: vocab indices must be in 1..{V} "
            f"(got {int(doc_idx.min())}..{int(doc_idx.max())}); indices are "
            "1-based as in the reference format"
        )
    cell = row * V + idx - 1
    if np.dtype(dtype) == np.float64:
        return np.bincount(cell, weights=entries[:, 1], minlength=D * V).reshape(D, V)
    dense = np.zeros(D * V, dtype=dtype)
    np.add.at(dense, cell, entries[:, 1])
    return dense.reshape(D, V)


def dense_to_sparse(dense: np.ndarray) -> List[np.ndarray]:
    """Dense (D, V) counts -> list of (n, 2) 1-based (index, count) docs."""
    return [make_count_matrix(row) for row in np.asarray(dense)]
