"""Float64 re-scoring of restart-lane log-likelihoods for selection.

Counterpart of multimodalmusig_tpu/parallel/rescore.py. Lanes fit in
float32 drift apart by rounding over hundreds of iterations, while the
winner margins of a best-of-N selection are far smaller, so selection reads
exact float64 re-scores of each lane's final state instead of the in-fit
float32 ll. Here the re-score runs in torch.float64 on the device that
holds the lanes, and only the scores ((R, M), or (R,) for LDA and ILDA)
need to leave it. The shortlist is a copy of the JAX package's NumPy one;
the pickers that read the scores are parallel/restarts.py's torch ones, on
the same device, and `dense_rank_np`, `pick_optimal_modality_restarts_np`
and `pick_optimal_restart_np` are copies of the JAX package's NumPy ones,
for scores already on the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.special import safe_xlogy

__all__ = [
    "rescore_mmctm_f64",
    "rescore_immctm_f64",
    "rescore_lda_f64",
    "rescore_ilda_f64",
    "shortlist_lanes",
    "dense_rank_np",
    "pick_optimal_modality_restarts_np",
    "pick_optimal_restart_np",
    "SHORTLIST_WINDOW",
    "LANE_CHUNK",
]

# f32-vs-f64 scoring gap for the SAME state is ~1e-5 on BRCA-sized
# reductions (the JAX package's measurement); 1e-2 gives three orders of
# magnitude of safety margin while still shortlisting only near-winners.
SHORTLIST_WINDOW = 1e-2

# Lanes re-scored at once: bounds the (lanes, D, V) float64 mixture table
# (64 × 560 × 96 × 8 bytes = 28 MB on BRCA, whatever R is).
LANE_CHUNK = 64


def _lanes(t, lanes):
    """Rows `lanes` of a lane-first tensor (all of them for None)."""
    if lanes is None:
        return t
    return t.index_select(0, torch.as_tensor(np.asarray(lanes, dtype=np.int64), device=t.device))


def rescore_mmctm_f64(lam, gamma, X, config, lanes: Optional[np.ndarray] = None,
                      lane_chunk: int = LANE_CHUNK) -> torch.Tensor:
    """Exact float64 per-modality log-likelihoods of batched MMCTM final
    states (mmctm.modality_loglikelihoods, src/MMCTM.jl:384-448): props =
    softmax(λ block), ϕ = γ row-normalized, ll_m = Σ xlogy(X, props @ ϕ) /
    ΣX. `lam` is (R, D, MK) and `gamma` a tuple of (R, K_m, V_m), on any
    device; the scores are computed there, `lane_chunk` lanes at a time.
    `lanes` restricts to a subset (the rows of the returned (len(lanes), M)
    matrix follow its order); None scores every lane. Dead lanes (NaN
    states) come back NaN, and the pickers mask them."""
    device = lam.device
    lam = _lanes(lam, lanes)
    out = []
    for m in range(config.M):
        Xm = torch.as_tensor(X[m]).to(device=device, dtype=torch.float64)
        g = _lanes(gamma[m], lanes).to(torch.float64)
        phi = g / g.sum(dim=-1, keepdim=True)                                   # (R, K, V)
        scores = []
        for lo in range(0, lam.shape[0], lane_chunk):
            hi = lo + lane_chunk
            props = torch.softmax(config.block(lam[lo:hi], m).to(torch.float64), dim=-1)
            scores.append(safe_xlogy(Xm, props @ phi[lo:hi]).sum(dim=(-2, -1)) / Xm.sum())
        out.append(torch.cat(scores))
    return torch.stack(out, dim=-1)


def rescore_immctm_f64(lam, gamma, X, F, config, lanes: Optional[np.ndarray] = None,
                       lane_chunk: int = LANE_CHUNK) -> torch.Tensor:
    """Exact float64 per-modality log-likelihoods (R, M) of batched IMMCTM
    final states (immctm.modality_loglikelihoods, src/IMMCTM.jl:388-428):
    props = softmax(λ block), p(v|k) = Π_i ϕ_m,i[k, F_m,i[v]] with ϕ = γ
    row-normalized, ll_m = Σ xlogy(X, props @ p) / ΣX. `lam` is (R, D, MK),
    `gamma` [m][i] of (R, K_m, J_mi) and F the one-hot features [m][i] of
    (V_m, J_mi) (models/ilda.feature_onehots). `lanes` and `lane_chunk` as
    in `rescore_mmctm_f64`. Dead lanes (NaN states) come back NaN, and the
    pickers mask them."""
    device = lam.device
    lam = _lanes(lam, lanes).to(torch.float64)
    out = []
    for m in range(config.M):
        Xm = torch.as_tensor(X[m]).to(device=device, dtype=torch.float64)
        logB = 0.0
        for g, Fi in zip(gamma[m], F[m]):
            g = _lanes(g, lanes).to(torch.float64)
            logphi = torch.log(g / g.sum(dim=-1, keepdim=True))         # (R, K, J_i)
            value = torch.as_tensor(Fi, device=device).argmax(dim=1)    # (V,) value of v
            logB = logB + logphi[:, :, value]                           # (R, K, V)
        props = torch.softmax(config.block(lam, m), dim=-1)            # (R, D, K)
        B = torch.exp(logB)
        out.append(torch.cat([
            safe_xlogy(Xm, props[lo:lo + lane_chunk] @ B[lo:lo + lane_chunk])  # (r, D, V)
            .sum(dim=(-2, -1)) / Xm.sum()
            for lo in range(0, lam.shape[0], lane_chunk)
        ]))
    return torch.stack(out, dim=-1)


def _mixture_lls(theta, word_probs, X, lane_chunk: int = LANE_CHUNK) -> torch.Tensor:
    """(R,) Σ xlogy(X, θ·p(v|k)ᵀ) / ΣX in float64, `lane_chunk` lanes at a
    time: θ (R, D, K), word_probs (R, V, K), X (D, V)."""
    Xm = torch.as_tensor(X).to(device=theta.device, dtype=torch.float64)
    return torch.cat([
        safe_xlogy(Xm, theta[lo:lo + lane_chunk] @ word_probs[lo:lo + lane_chunk].mT)
        .sum(dim=(-2, -1)) / Xm.sum()
        for lo in range(0, theta.shape[0], lane_chunk)
    ])


def rescore_lda_f64(gamma, lam, X, lanes: Optional[np.ndarray] = None,
                    lane_chunk: int = LANE_CHUNK) -> torch.Tensor:
    """Exact float64 log-likelihoods (R,) of batched LDA final states
    (lda.loglikelihood, src/LDA.jl:174-190): θ = γ normalized over topics,
    β = λ normalized over the vocabulary, ll = Σ xlogy(X, θβᵀ) / ΣX.
    `gamma` is (R, D, K) and `lam` (R, V, K), on any device; the scores are
    computed there, `lane_chunk` lanes at a time. `lanes` restricts to a
    subset, in its order. Dead lanes (NaN states) come back NaN."""
    g = _lanes(gamma, lanes).to(torch.float64)
    lam = _lanes(lam, lanes).to(torch.float64)
    return _mixture_lls(g / g.sum(dim=-1, keepdim=True), lam / lam.sum(dim=-2, keepdim=True), X,
                        lane_chunk)


def rescore_ilda_f64(gamma, lam, X, F, lanes: Optional[np.ndarray] = None,
                     lane_chunk: int = LANE_CHUNK) -> torch.Tensor:
    """Exact float64 log-likelihoods (R,) of batched ILDA final states
    (ilda.loglikelihood, src/ILDA.jl:209-236): p(v|k) = Π_i β_i[F_i[v], k]
    with β_i = λ_i normalized over its values. `gamma` is (R, D, K), `lam`
    a tuple over the features of (R, J_i, K) and F the one-hot features
    (V, J_i) (models/ilda.feature_onehots). As `rescore_lda_f64`
    otherwise."""
    g = _lanes(gamma, lanes).to(torch.float64)
    logB = 0.0
    for l, Fi in zip(lam, F):
        l = _lanes(l, lanes).to(torch.float64)
        value = torch.as_tensor(Fi, device=l.device).argmax(dim=1)     # (V,) value of v
        logB = logB + torch.log(l / l.sum(dim=-2, keepdim=True))[:, value, :]
    return _mixture_lls(g / g.sum(dim=-1, keepdim=True), torch.exp(logB), X, lane_chunk)


def shortlist_lanes(ll_f32, window: float = SHORTLIST_WINDOW) -> np.ndarray:
    """Candidate lanes for exact re-scoring: every lane whose in-fit f32 ll
    is within `window` of the per-modality f32 leader in ANY modality. The
    f32-vs-f64 gap for the same state is pure scoring rounding (~1e-5), so
    the true per-modality winners are always inside a 1e-2 window. If every
    lane diverged, all are candidates."""
    ll = np.asarray(ll_f32, np.float64)
    if ll.ndim == 1:
        ll = ll[:, None]
    masked = np.where(np.isfinite(ll), ll, -np.inf)
    top = masked.max(axis=0, keepdims=True)
    cand = (masked >= top - window).any(axis=1)
    if not cand.any():
        cand = np.ones(ll.shape[0], bool)
    return np.nonzero(cand)[0]


# ---------------------------------------------------------------------------
# Selection on scores held on the host (the JAX package's NumPy pickers,
# parallel/rescore.py:242-266 there; parallel/restarts.py has the torch ones)
# ---------------------------------------------------------------------------


def dense_rank_np(values: np.ndarray) -> np.ndarray:
    """StatsBase.denserank (run_mmctm.jl:143): 1 for the smallest value,
    equal values sharing a rank."""
    _, inv = np.unique(values, return_inverse=True)
    return inv + 1


def pick_optimal_modality_restarts_np(ll: np.ndarray) -> np.ndarray:
    """(R, M) lls -> (M,) the winning lane per modality, non-finite lanes
    excluded (run_mmctm.jl:86-97)."""
    masked = np.where(np.isfinite(ll), ll, -np.inf)
    return np.argmax(masked, axis=0)


def pick_optimal_restart_np(ll: np.ndarray) -> int:
    """(R, M) lls (or (R,)) -> the lane minimizing the mean dense rank of |ll|
    over the modalities; a lane with a non-finite ll ranks last
    (run_mmctm.jl:136-147)."""
    ll = np.asarray(ll, np.float64)
    if ll.ndim == 1:
        ll = ll[:, None]
    vals = np.where(np.isfinite(ll), np.abs(ll), np.inf)
    ranks = np.stack([dense_rank_np(vals[:, m]) for m in range(ll.shape[1])], axis=1)
    mean_rank = np.where(np.all(np.isfinite(ll), axis=1), ranks.mean(axis=1), np.inf)
    return int(np.argmin(mean_rank))
