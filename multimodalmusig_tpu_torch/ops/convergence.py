"""Convergence checks for the CAVI outer loops (reference: src/common.jl:48-56).

Counterpart of multimodalmusig_tpu/ops/convergence.py, batched over any
leading (restart) dimensions.
"""

from __future__ import annotations

import torch

__all__ = ["relative_change", "check_convergence", "MIN_ITERS_BEFORE_CONVERGENCE"]

# The reference only starts testing convergence once `length(ll) > 10`
# (src/LDA.jl:216, src/MMCTM.jl:485, src/IMMCTM.jl:459).
MIN_ITERS_BEFORE_CONVERGENCE = 10


def relative_change(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """max(|prev - curr| / |curr|) over the last (metric) axis: a scalar for
    one (M,) ll vector, (R,) for (R, M) restart lanes."""
    return ((prev - curr).abs() / curr.abs()).amax(dim=-1)


def check_convergence(prev: torch.Tensor, curr: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """True where the relative change between successive metrics is < tol
    (both dispatches of src/common.jl:48-56): `prev`/`curr` are the last two
    ll entries, scalars for LDA/ILDA and (M,) vectors for MMCTM/IMMCTM, or
    (R, M) restart lanes (one flag per lane)."""
    return relative_change(torch.atleast_1d(prev), torch.atleast_1d(curr)) < tol
