"""The port's `sparse_to_dense`, one vectorized scatter, against the JAX
package's loop of one `np.add.at` per document: the same bits and dtype on
ragged corpora (empty documents in every form, duplicate indices, lists of
lists, non-integer counts, one document and a cohort's 3,000), and the same
`ValueError` naming the first document with an index outside 1..V."""

import numpy as np
import pytest

from multimodalmusig_tpu.utils import formatting as jax_formatting

from multimodalmusig_tpu_torch.utils import formatting

EMPTY_FORMS = (lambda: np.zeros((0, 2), np.int64), lambda: np.zeros((0,)), lambda: [])


def _doc(rng, V, n, duplicates, fractional):
    idx = (rng.integers(1, V + 1, n) if duplicates
           else rng.permutation(V)[:n] + 1)
    if fractional:
        return np.stack([idx.astype(np.float64), rng.gamma(0.7, 3.0, n)], axis=1)
    return np.stack([idx, rng.integers(1, 40, n)], axis=1).astype(np.int64)


def _corpus(kind, rng):
    """(documents, V) of one kind of corpus; every kind has empty documents
    in each of the three forms but `single`."""
    D, V = {"ragged": (60, 96), "duplicates": (40, 48), "lists": (50, 83),
            "fractional": (45, 96), "single": (1, 96), "cohort": (3000, 83)}[kind]
    docs = []
    for d in range(D):
        if kind != "single" and d % 5 == 2:
            docs.append(EMPTY_FORMS[(d // 5) % 3]())
            continue
        n = int(rng.integers(1, 3 * V if kind == "duplicates" else V + 1))
        doc = _doc(rng, V, n, duplicates=kind in ("duplicates", "fractional"),
                   fractional=kind == "fractional" and d % 2 == 0)
        docs.append(doc.tolist() if kind == "lists" else doc)
    return docs, V


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["ragged", "duplicates", "lists", "fractional", "single",
                                  "cohort"])
def test_sparse_to_dense_gives_the_jax_packages_bits(kind, dtype):
    docs, V = _corpus(kind, np.random.default_rng(sum(map(ord, kind))))
    got = formatting.sparse_to_dense(docs, V, dtype=dtype)
    want = jax_formatting.sparse_to_dense(docs, V, dtype=dtype)
    assert got.dtype == want.dtype == np.dtype(dtype)
    assert got.shape == (len(docs), V)
    assert np.array_equal(got, want)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("bad", ["zero", "above"])
@pytest.mark.parametrize("d", [0, 7, 29])
def test_an_index_outside_the_vocabulary_names_the_first_document(bad, d):
    docs, V = _corpus("ragged", np.random.default_rng(5))
    docs = docs[:30]
    value = 0 if bad == "zero" else V + 1
    docs[d] = np.array([[3, 2], [value, 1], [V, 4]], np.int64)
    if d < 29:  # a later offender is not the one named
        docs[29] = np.array([[V + 5, 1]], np.int64)
    with pytest.raises(ValueError) as want:
        jax_formatting.sparse_to_dense(docs, V)
    with pytest.raises(ValueError) as got:
        formatting.sparse_to_dense(docs, V)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(f"document {d}: vocab indices must be in 1..{V} ")


@pytest.mark.parametrize("D", [0, 1, 6])
def test_a_corpus_of_empty_documents_gives_zeros(D):
    docs = [EMPTY_FORMS[d % 3]() for d in range(D)]
    for dtype in (np.float64, np.float32):
        got = formatting.sparse_to_dense(docs, 48, dtype=dtype)
        assert got.dtype == np.dtype(dtype) and got.shape == (D, 48)
        assert not got.any()
        assert np.array_equal(got, jax_formatting.sparse_to_dense(docs, 48, dtype=dtype))
