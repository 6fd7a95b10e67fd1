"""Model checkpoints and the CLI's TSV writers.

Counterpart of multimodalmusig_tpu/utils/io.py, in its file format, so
either package loads the other's checkpoints:

  * `save_model` / `load_model`: an `LDA`, `ILDA`, `MMCTM` or `IMMCTM`
    wrapper (constructor arguments, sparse counts, the whole variational
    state and the fit's outcome) as one .npz; a loaded model resumes its fit
    where it stopped (the reference's warm start, src/MMCTM.jl:514-520);
  * `cov2cor` and `write_mean/cov/cor/sigs/props`: the reference CLI's TSV
    outputs (scripts/run_mmctm.jl:184-240, 272-290), written with numpy and
    `csv` (the JAX package's writers use pandas).

The .npz keys are `state.<field>[.<m>[.<i>]]` (one-lane state tensors
without their lane dimension, as the JAX package's states have none),
`X.<d>.<m>` (document d's (n, 2) counts of modality m; `X.<d>` for LDA and
ILDA), `features.<m>` (IMMCTM) or `features` (ILDA) and `__meta__`, a JSON
blob {"kind", "dtype" (a numpy name), "ctor", "n_docs", "n_modalities" (the
CTM families), "fitted"}.
"""

from __future__ import annotations

import csv
import json
from typing import List

import numpy as np
import torch

from ..models.ilda import ILDA
from ..models.immctm import IMMCTM
from ..models.lda import LDA
from ..models.mmctm import MMCTM

__all__ = [
    "save_model",
    "load_model",
    "cov2cor",
    "write_mean",
    "write_cov",
    "write_cor",
    "write_sigs",
    "write_props",
]


def _flatten_state(state, prefix: str, out: dict):
    """The state's tensors as numpy arrays under dotted keys, lane 0 only."""
    if hasattr(state, "_asdict"):
        for name, val in state._asdict().items():
            _flatten_state(val, f"{prefix}{name}.", out)
    elif isinstance(state, tuple):
        for i, item in enumerate(state):
            _flatten_state(item, f"{prefix}{i}.", out)
    else:
        if state.shape[0] != 1:
            raise ValueError(f"a checkpoint holds one lane, the state has {state.shape[0]}")
        out[prefix.rstrip(".")] = state[0].detach().cpu().numpy()


def _unflatten_into(template, prefix: str, arrays: dict, dtype, device):
    """A state shaped as `template` from the dotted keys, with the lane
    dimension added back."""
    if hasattr(template, "_asdict"):
        return type(template)(**{
            name: _unflatten_into(val, f"{prefix}{name}.", arrays, dtype, device)
            for name, val in template._asdict().items()
        })
    if isinstance(template, tuple):
        return tuple(_unflatten_into(item, f"{prefix}{i}.", arrays, dtype, device)
                     for i, item in enumerate(template))
    return torch.as_tensor(arrays[prefix.rstrip(".")], dtype=dtype, device=device).unsqueeze(0)


def save_model(path: str, model) -> None:
    """Checkpoint an `LDA`, `ILDA`, `MMCTM` or `IMMCTM` wrapper to .npz, in
    the JAX package's format: what it takes to rebuild the model and resume
    its fit. Any other type raises TypeError."""
    arrays: dict = {}
    if isinstance(model, IMMCTM):
        kind = "IMMCTM"
        ctor = {"k": model.K, "alpha": model.alpha}
        for m, f in enumerate(model.features):
            arrays[f"features.{m}"] = f
    elif isinstance(model, MMCTM):
        kind = "MMCTM"
        ctor = {"k": model.K, "alpha": model.alpha, "V": model.V}
    elif isinstance(model, ILDA):
        kind = "ILDA"
        ctor = {"k": model.K, "alpha": model.alpha, "eta": model.eta}
        arrays["features"] = model.features
    elif isinstance(model, LDA):
        kind = "LDA"
        ctor = {"k": model.K, "alpha": model.alpha, "eta": model.eta, "V": model.V}
    else:
        raise TypeError(f"cannot checkpoint {type(model)!r}")
    _flatten_state(model.state, "state.", arrays)
    meta = {"kind": kind, "dtype": str(model.config.dtype).removeprefix("torch."), "ctor": ctor,
            "n_docs": len(model.X)}
    if kind in ("LDA", "ILDA"):
        for d, doc in enumerate(model.X):
            arrays[f"X.{d}"] = np.asarray(doc)
    else:
        meta["n_modalities"] = model.M
        for d, doc in enumerate(model.X):
            for m in range(model.M):
                arrays[f"X.{d}.{m}"] = np.asarray(doc[m])
    meta["fitted"] = {"converged": bool(model.converged), "elbo": model.elbo, "ll": model.ll}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_model(path: str, device="cuda"):
    """Rebuild an `LDA`, `ILDA`, `MMCTM` or `IMMCTM` wrapper from a
    checkpoint of either package, on `device`: the CUDA card unless the
    caller asks for the CPU (without a card a CUDA device raises)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    kind, ctor = meta["kind"], meta["ctor"]
    dtype = getattr(torch, meta["dtype"])
    if kind in ("LDA", "ILDA"):
        X = [arrays[f"X.{d}"] for d in range(meta["n_docs"])]
    else:
        X = [[arrays[f"X.{d}.{m}"] for m in range(meta["n_modalities"])]
             for d in range(meta["n_docs"])]
    if kind == "LDA":
        model = LDA(ctor["k"], ctor["alpha"], ctor["eta"], ctor["V"], X, dtype=dtype,
                    device=device)
    elif kind == "ILDA":
        model = ILDA(ctor["k"], ctor["alpha"], ctor["eta"], arrays["features"], X, dtype=dtype,
                     device=device)
    elif kind == "MMCTM":
        model = MMCTM(ctor["k"], ctor["alpha"], ctor["V"], X, dtype=dtype, device=device)
    elif kind == "IMMCTM":
        features = [arrays[f"features.{m}"] for m in range(meta["n_modalities"])]
        model = IMMCTM(ctor["k"], ctor["alpha"], features, X, dtype=dtype, device=device)
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    model.state = _unflatten_into(model.state, "state.", arrays, dtype, model.device)
    fitted = meta["fitted"]
    model.converged = fitted["converged"]
    model.elbo = fitted["elbo"]
    model.ll = fitted["ll"]
    return model


# ---------------------------------------------------------------------------
# TSV writers (run_mmctm.jl:184-240, 272-290)
# ---------------------------------------------------------------------------


def cov2cor(C) -> np.ndarray:
    """Covariance -> correlation (run_mmctm.jl:184-187)."""
    C = np.asarray(C)
    sigma = np.sqrt(np.diag(C))
    return C / np.outer(sigma, sigma)


def write_mean(path, model):
    """μ, one value per line."""
    np.savetxt(path, model.mu, delimiter="\t")


def write_cov(path, model):
    """Σ as an MK × MK tab-separated matrix."""
    np.savetxt(path, model.Sigma, delimiter="\t")


def write_cor(path, model):
    """The correlation matrix of Σ."""
    np.savetxt(path, cov2cor(model.Sigma), delimiter="\t")


def _write_table(path, header, rows):
    """A tab-separated table as pandas' `to_csv(sep="\\t", index=False)`
    writes it: minimal quoting, "\\n" line ends, floats in their shortest
    round-trip form (repr)."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(header)
        writer.writerows(rows)


def write_sigs(path, model: MMCTM, terms: List[List[str]], modalities: List[str]):
    """The tidy signature table (run_mmctm.jl:189-209): one row per
    modality × topic × vocabulary item, with the item's probability in the
    topic, γ normalized in float64."""
    rows = []
    gamma = model.gamma
    for m in range(model.M):
        for k in range(model.K[m]):
            g = np.asarray(gamma[m][k], dtype=np.float64)
            probs = g / g.sum()
            for v in range(model.V[m]):
                rows.append((modalities[m], k + 1, v + 1, terms[m][v], float(probs[v])))
    _write_table(path, ["modality", "topic", "value", "term", "probability"], rows)


def write_props(path, model: MMCTM, samples: List[str], modalities: List[str]):
    """Per-sample signature proportions, the softmax of each modality's
    block of λ (run_mmctm.jl:216-240): one row per topic ("SNV-1", ...),
    one column per sample."""
    props = np.empty((sum(model.K), model.D))
    for d, lam in enumerate(model.lam):
        start = 0
        for m in range(model.M):
            stop = start + model.K[m]
            e = np.exp(lam[start:stop] - lam[start:stop].max())
            props[start:stop, d] = e / e.sum()
            start = stop
    labels = [f"{modalities[m]}-{k + 1}" for m in range(model.M) for k in range(model.K[m])]
    _write_table(path, ["topic"] + list(samples),
                 ([label] + [float(x) for x in row] for label, row in zip(labels, props)))
