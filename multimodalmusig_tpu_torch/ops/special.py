"""Special functions shared by the variational updates, on `torch.special`.

Counterpart of multimodalmusig_tpu/ops/special.py (reference:
src/common.jl:1-9 `logmvbeta`; src/MMCTM.jl:214-222 Dirichlet digamma
expectations). Batched and dtype-polymorphic.
"""

from __future__ import annotations

import torch
from torch.special import digamma, gammaln

__all__ = [
    "logmvbeta",
    "logmvbeta_symmetric",
    "dirichlet_expectation",
    "xlogx",
    "safe_xlogy",
]


def logmvbeta(vals: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """log multivariate Beta: sum(lgamma(v_i)) - lgamma(sum(v_i)) along `axis`."""
    return gammaln(vals).sum(dim=axis) - gammaln(vals.sum(dim=axis))


def logmvbeta_symmetric(alpha: torch.Tensor, n) -> torch.Tensor:
    """logmvbeta(fill(alpha, n)) without materializing the filled vector
    (reference: src/MMCTM.jl:276 `logmvbeta(fill(α, V))`)."""
    return n * gammaln(alpha) - gammaln(n * alpha)


def dirichlet_expectation(params: torch.Tensor, axis: int, total=None) -> torch.Tensor:
    """E[ln p] under Dirichlet(params), normalizing over `axis`:
    digamma(p) - digamma(sum(p, axis)) (reference: src/MMCTM.jl:214-222).
    `total`, when given, is that sum with the axis kept, e.g. one reduced
    over the vocabulary slices of a vocab-sharded fit."""
    if total is None:
        total = params.sum(dim=axis, keepdim=True)
    return digamma(params) - digamma(total)


def xlogx(x: torch.Tensor) -> torch.Tensor:
    """x * log(x) with the 0*log(0) = 0 convention (entropy term ElnQZ,
    src/MMCTM.jl:362-370; f32 responsibilities can underflow to 0)."""
    pos = x > 0
    return torch.where(pos, x * torch.log(torch.where(pos, x, 1.0)), 0.0)


def safe_xlogy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x * log(y) treating x == 0 as exact zero (zero-count cells of the
    dense count tensor must not contribute 0 * -inf = NaN)."""
    nz = x != 0
    return torch.where(nz, x * torch.log(torch.where(nz, y, 1.0)), 0.0)
