"""Best-of-N restart fitting, with restarts as a leading tensor dimension.

Counterpart of the unchunked path of multimodalmusig_tpu/parallel/restarts.py,
which replaced the reference's `Distributed.pmap` restart fan-out
(scripts/run_mmctm.jl:99-161) by a `vmap` axis. Here every state tensor
carries the R lanes as its first dimension and one host loop drives them
all (models/ctm_base.run_cavi); finished lanes are frozen, so each lane's
trajectory is that of its own single fit.
"""

from __future__ import annotations

from typing import Union

import torch

from ..models import mmctm as mmctm_mod
from ..models.mmctm import MMCTMConfig, MMCTMFitResult, MMCTMState

__all__ = [
    "dense_rank",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "lane",
    "fit_restarts_from_states",
    "fit_restarts",
]


def dense_rank(values: torch.Tensor) -> torch.Tensor:
    """StatsBase.denserank of a 1-D tensor: the smallest value gets rank 1,
    ties share a rank, ranks are consecutive (run_mmctm.jl:143)."""
    s, _ = torch.sort(values)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]])
    distinct = torch.cumsum(is_new, dim=0)
    return distinct[torch.searchsorted(s, values, side="left")]


def pick_optimal_modality_restarts(ll: torch.Tensor) -> torch.Tensor:
    """(R, M) lls -> (M,) restart index with the best ll per modality
    (run_mmctm.jl:86-97). Non-finite (diverged) lanes are excluded."""
    return torch.where(torch.isfinite(ll), ll, -torch.inf).argmax(dim=0)


def pick_optimal_restart(ll: torch.Tensor) -> torch.Tensor:
    """(R, M) lls -> scalar index minimizing the mean dense rank of |ll|
    across modalities (run_mmctm.jl:136-147). Non-finite lanes rank last."""
    finite = torch.isfinite(ll)
    absll = torch.where(finite, ll.abs(), torch.inf)
    ranks = torch.stack([dense_rank(absll[:, m].contiguous()) for m in range(ll.shape[1])], dim=1)
    mean_rank = torch.where(finite.all(dim=1), ranks.to(ll.dtype).mean(dim=1), torch.inf)
    return mean_rank.argmin()


def lane(batched, i: int):
    """Restart lane i of a batched result or state, keeping a leading
    dimension of 1 so it is itself a valid (R = 1) result or state."""
    if isinstance(batched, tuple):
        parts = [lane(x, i) for x in batched]
        return type(batched)(*parts) if hasattr(batched, "_fields") else tuple(parts)
    return batched[i : i + 1]


def fit_restarts_from_states(state: MMCTMState, X, config: MMCTMConfig,
                             maxiter: int = 1000, tol: float = 1e-4) -> MMCTMFitResult:
    """Fit every lane of a batched initial `state` (counterpart of the JAX
    package's fit_restarts_from_keys, with the init handed in: a state from
    `mmctm.init_with_alpha`, or one injected by `interop.state_from_numpy`).
    X is a tuple of dense (D, V_m) counts, moved to the state's device."""
    X = mmctm_mod.counts_tensors(X, config, state.lam.device)
    return mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol)


def fit_restarts(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                 alpha, restarts: int, maxiter: int = 1000, tol: float = 1e-4,
                 init_method: str = "random", device="cpu") -> MMCTMFitResult:
    """Fit `restarts` independently initialized MMCTMs as one batch on
    `device` (replaces pmap(fit_restart), run_mmctm.jl:99-111). Returns a
    batched MMCTMFitResult with a leading restart dimension. An int seeds a
    CPU torch.Generator, so the inits do not depend on the device."""
    generator = (
        seed_or_generator if isinstance(seed_or_generator, torch.Generator)
        else torch.Generator().manual_seed(int(seed_or_generator))
    )
    X = mmctm_mod.counts_tensors(X, config, device)
    state = mmctm_mod.init_with_alpha(
        generator, config, X, alpha, restarts=restarts, init_method=init_method, device=device
    )
    return fit_restarts_from_states(state, X, config, maxiter=maxiter, tol=tol)
