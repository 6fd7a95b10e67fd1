"""Float64 re-scoring of restart-lane log-likelihoods for selection.

Counterpart of multimodalmusig_tpu/parallel/rescore.py. Lanes fit in
float32 drift apart by rounding over hundreds of iterations, while the
winner margins of a best-of-N selection are far smaller, so selection reads
exact float64 re-scores of each lane's final state instead of the in-fit
float32 ll. Here the re-score runs in torch.float64 on the device that
holds the lanes, and only the (R, M) scores need to leave it.
"""

from __future__ import annotations

import torch

from ..ops.special import safe_xlogy

__all__ = ["rescore_immctm_f64"]


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
