"""Float64 re-scoring of restart-lane log-likelihoods for selection.

Counterpart of multimodalmusig_tpu/parallel/rescore.py. Lanes fit in
float32 drift apart by rounding over hundreds of iterations, while the
winner margins of a best-of-N selection are far smaller, so selection reads
exact float64 re-scores of each lane's final state instead of the in-fit
float32 ll. Here the re-score runs in torch.float64 on the device that
holds the lanes, and only the (R, M) scores need to leave it. The
shortlist is a copy of the JAX package's NumPy one; the pickers that read
the scores are parallel/restarts.py's torch ones, on the same device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.special import safe_xlogy

__all__ = [
    "rescore_mmctm_f64",
    "rescore_immctm_f64",
    "shortlist_lanes",
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


def rescore_mmctm_f64(lam, gamma, X, config, lanes: Optional[np.ndarray] = None) -> torch.Tensor:
    """Exact float64 per-modality log-likelihoods of batched MMCTM final
    states (mmctm.modality_loglikelihoods, src/MMCTM.jl:384-448): props =
    softmax(λ block), ϕ = γ row-normalized, ll_m = Σ xlogy(X, props @ ϕ) /
    ΣX. `lam` is (R, D, MK) and `gamma` a tuple of (R, K_m, V_m), on any
    device; the scores are computed there, LANE_CHUNK lanes at a time.
    `lanes` restricts to a subset (the rows of the returned (len(lanes), M)
    matrix follow its order); None scores every lane. Dead lanes (NaN
    states) come back NaN, and the pickers mask them."""
    device = lam.device
    if lanes is not None:
        idx = torch.as_tensor(np.asarray(lanes, dtype=np.int64), device=device)
        lam = lam.index_select(0, idx)
        gamma = tuple(g.index_select(0, idx) for g in gamma)
    out = []
    for m in range(config.M):
        Xm = torch.as_tensor(X[m]).to(device=device, dtype=torch.float64)
        g = gamma[m].to(torch.float64)
        phi = g / g.sum(dim=-1, keepdim=True)                                   # (R, K, V)
        scores = []
        for lo in range(0, lam.shape[0], LANE_CHUNK):
            hi = lo + LANE_CHUNK
            props = torch.softmax(config.block(lam[lo:hi], m).to(torch.float64), dim=-1)
            scores.append(safe_xlogy(Xm, props @ phi[lo:hi]).sum(dim=(-2, -1)) / Xm.sum())
        out.append(torch.cat(scores))
    return torch.stack(out, dim=-1)


def rescore_immctm_f64(lam, gamma, X, F, config) -> torch.Tensor:
    """Exact float64 per-modality log-likelihoods (R, M) of batched IMMCTM
    final states (immctm.modality_loglikelihoods, src/IMMCTM.jl:388-428):
    props = softmax(λ block), p(v|k) = Π_i ϕ_m,i[k, F_m,i[v]] with ϕ = γ
    row-normalized, ll_m = Σ xlogy(X, props @ p) / ΣX. `lam` is (R, D, MK),
    `gamma` [m][i] of (R, K_m, J_mi) and F the one-hot features [m][i] of
    (V_m, J_mi) (models/ilda.feature_onehots). Dead lanes (NaN states) come
    back NaN, and the pickers mask them."""
    device = lam.device
    lam = lam.to(torch.float64)
    out = []
    for m in range(config.M):
        Xm = torch.as_tensor(X[m]).to(device=device, dtype=torch.float64)
        logB = 0.0
        for g, Fi in zip(gamma[m], F[m]):
            g = g.to(torch.float64)
            logphi = torch.log(g / g.sum(dim=-1, keepdim=True))         # (R, K, J_i)
            value = torch.as_tensor(Fi, device=device).argmax(dim=1)    # (V,) value of v
            logB = logB + logphi[:, :, value]                           # (R, K, V)
        props = torch.softmax(config.block(lam, m), dim=-1)            # (R, D, K)
        P = props @ torch.exp(logB)                                     # (R, D, V)
        out.append(safe_xlogy(Xm, P).sum(dim=(-2, -1)) / Xm.sum())
    return torch.stack(out, dim=-1)


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
