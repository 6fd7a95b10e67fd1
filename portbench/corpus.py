"""The benchmark's inputs: count matrices read from TSVs or synthesized,
in NumPy, and the two forms the program takes them in.

`synthesize_corpus` is a copy of the generator of the repository's
tools/pcawg_bench.py (documents drawn from a ground-truth topic mixture,
per-document totals Poisson around a mean count), kept here so that a
later change to the program cannot change the yardstick.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def read_counts_tsv(path):
    """(counts (D, V) float64, terms [V], samples [D]) of a TSV whose first
    column is `term` and whose other columns are samples."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    terms = [r[0] for r in rows]
    counts = np.array([[float(x) for x in r[1:]] for r in rows], dtype=np.float64).T
    return counts, terms, header[1:]


def write_counts_tsv(path, counts, terms, samples):
    """The inverse of `read_counts_tsv`, counts as integers."""
    with open(path, "w") as f:
        f.write("\t".join(["term", *samples]) + "\n")
        for v, term in enumerate(terms):
            f.write("\t".join([term, *(str(int(c)) for c in counts[:, v])]) + "\n")


def synthesize_corpus(rng, D, V_list, K_list, mean_counts, topic_conc, prop_conc):
    """Topic-model-distributed counts: per modality, K topics drawn from a
    symmetric Dirichlet(topic_conc) over V items, each document's
    proportions from Dirichlet(prop_conc), its total from
    Poisson(mean_count), its counts multinomial. Returns a list of (D, V)
    float64 arrays."""
    X = []
    for V, K, mean_n in zip(V_list, K_list, mean_counts):
        topics = rng.dirichlet(np.full(V, topic_conc), size=K)  # (K, V)
        props = rng.dirichlet(np.full(K, prop_conc), size=D)    # (D, K)
        P = props @ topics
        N = rng.poisson(mean_n, size=D)
        counts = np.stack([rng.multinomial(n, p) for n, p in zip(N, P)])
        X.append(counts.astype(np.float64))
    return X


def load(config):
    """The configuration's corpus: {"X": list of dense (D, V_m) float64,
    "terms": list of per-modality term names, "samples": [D], "tsv": the
    per-modality TSV paths (for the CLI), or None before `write_tsvs`}."""
    data = config["data"]
    if data["kind"] == "tsv":
        loaded = [read_counts_tsv(os.path.join(HERE, p)) for p in data["files"]]
        samples = loaded[0][2]
        for _, _, s in loaded[1:]:
            if s != samples:
                raise ValueError("the modality files list different samples")
        return {"X": [c for c, _, _ in loaded], "terms": [t for _, t, _ in loaded],
                "samples": samples, "tsv": [os.path.join(HERE, p) for p in data["files"]]}
    if data["kind"] == "synthetic":
        rng = np.random.default_rng(int(data["seed"]))
        X = synthesize_corpus(rng, int(config["D"]), config["V"], config["K"],
                              data["mean_counts"], data["topic_concentration"],
                              data["proportion_concentration"])
        terms = [[f"{name}{v + 1}" for v in range(V)]
                 for name, V in zip(config["modalities"], config["V"])]
        return {"X": X, "terms": terms, "samples": [f"S{d + 1}" for d in range(config["D"])],
                "tsv": None}
    raise ValueError(f"unknown data kind {data['kind']!r}")


def write_tsvs(corpus, config, directory):
    """Write a corpus that has no TSVs of its own into `directory` once, for
    the CLI; sets corpus["tsv"]."""
    if corpus["tsv"] is not None:
        return
    os.makedirs(directory, exist_ok=True)
    paths = []
    for m, name in enumerate(config["modalities"]):
        path = os.path.join(directory, f"{name}_counts.tsv")
        write_counts_tsv(path, corpus["X"][m], corpus["terms"][m], corpus["samples"])
        paths.append(path)
    corpus["tsv"] = paths


def sparse_docs(X):
    """X[doc][modality] as (n, 2) int64 matrices of 1-based (item, count)
    pairs, the form of the model's constructor."""
    D = X[0].shape[0]
    docs = []
    for d in range(D):
        row = []
        for Xm in X:
            idx = np.nonzero(Xm[d] > 0)[0]
            row.append(np.stack([idx + 1, Xm[d, idx]], axis=1).astype(np.int64))
        docs.append(row)
    return docs
