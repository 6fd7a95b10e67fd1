"""Best-of-N restart fitting, with restarts as a leading tensor dimension.

Counterpart of multimodalmusig_tpu/parallel/restarts.py (MMCTM and IMMCTM),
which replaced the reference's `Distributed.pmap` restart fan-out
(scripts/run_mmctm.jl:99-161) by a `vmap` axis. Here every state tensor
carries the R lanes as its first dimension and one host loop drives them
all (models/ctm_base.run_cavi_from); finished lanes are frozen, so each
lane's trajectory is that of its own single fit.

The MMCTM path is the reference CLI's two-stage protocol
(`fit_mmctm_restarts`, run_mmctm.jl:163-180):
  1. R random inits fit at tol 1e-4 (`fit_restarts`, optionally with
     straggler compaction); per modality, the lane with the best
     log-likelihood wins (run_mmctm.jl:86-97), read from exact float64
     re-scores (parallel/rescore.py);
  2. fresh models with the winners' topic-word posteriors grafted in
     (γ and E[ln ϕ] per modality, run_mmctm.jl:113-134) refit at tol 1e-5;
     the lane with the least mean dense rank of |ll| is the result
     (run_mmctm.jl:136-147).

Documented divergence, as in the JAX package (its restarts.py:21-30): the
reference's stage-2 restarts are deterministic duplicates. The graft
overwrites γ/E[ln ϕ] of every modality, which is the only random part of an
init (λ=0, ν=1, μ=0, Σ=I and the uniform θ are fixed), so its R stage-2
workers compute R identical models and the rank pick returns the first.
Stage 2 therefore runs once by default (`stage2_restarts=1`); more lanes
only add identical copies.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..models import ctm_base
from ..models import immctm as immctm_mod
from ..models import mmctm as mmctm_mod
from ..models.immctm import IMMCTM, IMMCTMConfig, IMMCTMFitResult, IMMCTMState
from ..models.mmctm import MMCTM, MMCTMConfig, MMCTMFitResult, MMCTMState
from .rescore import rescore_immctm_f64, rescore_mmctm_f64, shortlist_lanes

__all__ = [
    "dense_rank",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "lane",
    "suggest_compact_schedule",
    "fit_restarts_from_states",
    "fit_restarts",
    "select_modality_winners_f64",
    "select_best_restart_f64",
    "two_stage_fit_from_states",
    "two_stage_fit",
    "fit_mmctm_restarts",
    "fit_immctm_restarts_from_states",
    "fit_immctm_restarts",
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


# ---------------------------------------------------------------------------
# Straggler compaction schedules (restarts.py:67-204 of the JAX package; the
# compacted loop itself is ctm_base.run_cavi)
# ---------------------------------------------------------------------------


def suggest_compact_schedule(
    iters,
    maxiter: Optional[int] = None,
    boundary_cost_lane_iters: float = 8_000.0,
    max_boundaries: int = 3,
    production_restarts: Optional[int] = None,
    margin_z: float = 1.0,
):
    """Compaction boundaries for `fit_restarts(compact_schedule=...)` from a
    pilot fit's per-lane iteration counts (a FitResult's n_iters), as the
    cumulative-budget increments (c1, c2, ...), or () when no boundary beats
    the single run. A copy of the JAX package's function (its docstring,
    restarts.py:75-118, gives the model): the boundaries are placed exactly
    by dynamic programming over the observed counts, a phase costing its
    active lanes (bucketed to the next power of two, with a margin_z-sigma
    margin on the survivor count) times its length, and each boundary
    `boundary_cost_lane_iters`. Its cost model prices the JAX package's
    power-of-two lane padding, which this package does not do, and its
    default boundary cost was measured on a remote-attached TPU; both are
    kept so the two packages suggest the same schedule."""
    iters = np.asarray(iters)
    iters = iters[np.isfinite(iters)].astype(np.int64)
    if iters.size == 0:
        return ()
    P = iters.size
    exact_counts = production_restarts is None
    R = P if exact_counts else int(production_restarts)
    hi = int(iters.max()) if maxiter is None else min(int(iters.max()), maxiter)
    cuts = np.unique(iters)
    cuts = cuts[cuts < hi]
    if cuts.size == 0:
        return ()

    def bucket(n):
        return 0 if n == 0 else 1 << (int(n) - 1).bit_length()

    sorted_it = np.sort(iters)

    def surv_pred(c):
        s_p = P - int(np.searchsorted(sorted_it, c, side="right"))
        if s_p == 0:
            return 0
        p = s_p / P
        if exact_counts:
            sd = np.sqrt(R * p * (1.0 - p))
        else:
            sd = R * np.sqrt(p * (1.0 - p) * (1.0 / P + 1.0 / R))
        return min(int(np.ceil(R * p + margin_z * sd)), R)

    surv_bucket = np.array([bucket(surv_pred(c)) for c in cuts], dtype=np.float64)
    cuts_f = cuts.astype(np.float64)
    n = cuts.size
    B = float(boundary_cost_lane_iters)

    # dp[j]: least cost of the phases up to a boundary at cuts[j] with
    # exactly k boundaries
    best_cost = float(R) * hi
    best_bounds = ()
    dp = R * cuts_f + B
    parents = []
    for k in range(1, max_boundaries + 1):
        finish = dp + surv_bucket * (hi - cuts_f)
        j = int(np.argmin(finish))
        if finish[j] < best_cost:
            best_cost = float(finish[j])
            chain = [j]
            for lvl in range(k - 2, -1, -1):
                chain.append(int(parents[lvl][chain[-1]]))
            best_bounds = tuple(int(cuts[i]) for i in reversed(chain))
        if k == max_boundaries:
            break
        trans = dp[:, None] + surv_bucket[:, None] * (cuts_f[None, :] - cuts_f[:, None]) + B
        trans[np.tril_indices(n)] = np.inf
        prev = np.argmin(trans, axis=0)
        parents.append(prev)
        dp = trans[prev, np.arange(n)]
    out, prev_c = [], 0
    for c in best_bounds:
        out.append(int(c) - prev_c)
        prev_c = int(c)
    return tuple(out)


def fit_restarts_from_states(state: MMCTMState, X, config: MMCTMConfig,
                             maxiter: int = 1000, tol: float = 1e-4,
                             compact_schedule: Optional[Sequence[int]] = None) -> MMCTMFitResult:
    """Fit every lane of a batched initial `state` (counterpart of the JAX
    package's fit_restarts_from_keys, with the init handed in: a state from
    `mmctm.init_with_alpha`, or one injected by `interop.state_from_numpy`).
    X is a tuple of dense (D, V_m) counts, moved to the state's device.
    `compact_schedule` as in `fit_restarts`."""
    X = mmctm_mod.counts_tensors(X, config, state.lam.device)
    return mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol,
                         compact_schedule=compact_schedule)


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def fit_restarts(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                 alpha, restarts: int, maxiter: int = 1000, tol: float = 1e-4,
                 init_method: str = "random",
                 compact_schedule: Optional[Sequence[int]] = None,
                 device="cuda") -> MMCTMFitResult:
    """Fit `restarts` independently initialized MMCTMs as one batch on
    `device`, the CUDA card unless the caller asks for the CPU (replaces
    pmap(fit_restart), run_mmctm.jl:99-111). Returns a batched
    MMCTMFitResult with a leading restart dimension. An int seeds a CPU
    torch.Generator, so the inits do not depend on the device.

    `compact_schedule=(c1, c2, ...)` is the straggler fit: the batch runs
    every lane until its slowest lane ends, so at R=1000 the long tail of
    iteration counts sets the work of every lane. With a schedule, all lanes
    run c1 iterations, the finished ones leave the batch, the survivors run
    c2 more, and so on; after the last boundary the survivors run to their
    end (`suggest_compact_schedule` picks boundaries). Finished lanes are
    frozen in both fits, so each lane's result equals the unchunked fit's
    (bit for bit on the CPU; in float32 on the card the smaller batches
    round differently, about 1e-3 on a few lanes' ll after hundreds of
    iterations). The compacted loop is ctm_base.run_cavi's."""
    device = ctm_base.check_device(device)
    X = mmctm_mod.counts_tensors(X, config, device)
    state = mmctm_mod.init_with_alpha(
        _generator(seed_or_generator), config, X, alpha, restarts=restarts,
        init_method=init_method, device=device,
    )
    return fit_restarts_from_states(state, X, config, maxiter=maxiter, tol=tol,
                                    compact_schedule=compact_schedule)


# ---------------------------------------------------------------------------
# Two-stage selection (restarts.py:1190-1493 of the JAX package)
# ---------------------------------------------------------------------------


def select_modality_winners_f64(stage1: MMCTMFitResult, X, config: MMCTMConfig):
    """Per-modality stage-1 winners by exact float64 re-scores of the final
    states: only the lanes within the shortlist window of the f32 leaders
    are re-scored (rescore.shortlist_lanes), which holds the true winners.
    Returns (best_m (M,) np.int64 lane indices, info {"rescored_lanes",
    "ll_f64": their (n, M) scores})."""
    cand = shortlist_lanes(stage1.ll.detach().to("cpu", torch.float64).numpy())
    ll64 = rescore_mmctm_f64(stage1.state.lam, stage1.state.gamma, X, config, lanes=cand)
    best_m = cand[pick_optimal_modality_restarts(ll64).cpu().numpy()]
    return best_m, {"rescored_lanes": cand, "ll_f64": ll64.cpu().numpy()}


def select_best_restart_f64(result: MMCTMFitResult, X, config: MMCTMConfig):
    """Dense-rank pick (run_mmctm.jl:136-147) over exact float64 re-scores
    of every lane's final state. Returns (best index, (R, M) f64 scores)."""
    ll64 = rescore_mmctm_f64(result.state.lam, result.state.gamma, X, config)
    return int(pick_optimal_restart(ll64)), ll64.cpu().numpy()


def two_stage_fit_from_states(state1: MMCTMState, X, config: MMCTMConfig, alpha,
                              stage2_restarts: int = 1, maxiter: int = 1000,
                              stage1_tol: float = 1e-4, stage2_tol: float = 1e-5,
                              init_method: str = "random",
                              compact_schedule: Optional[Sequence[int]] = None,
                              rescore_f64: bool = True, generator=None,
                              selection_info: Optional[dict] = None):
    """The two-stage protocol (run_mmctm.jl:163-180) from a batched stage-1
    initial state, on its device: stage 1 fits every lane (with
    `compact_schedule`, as `fit_restarts`); the per-modality winners' γ and
    E[ln ϕ] are grafted over `stage2_restarts` fresh inits drawn from
    `generator` (a CPU generator of their own by default) and refit at
    `stage2_tol`; the dense-rank pick chooses among them. Both picks read
    exact float64 re-scores unless `rescore_f64` is False (then the in-fit
    f32 lls). Runs with TF32 off throughout.

    `selection_info`, when a dict, receives {"stage1_winners" (M,),
    "stage1_winner_ll" (M,)}: the winners and the scores the pick read.
    Returns (the selected stage-2 lane (R = 1), stage-1 result, stage-2
    result, selected index)."""
    device = state1.lam.device
    X = mmctm_mod.counts_tensors(X, config, device)
    with ctm_base.full_f32_matmuls():
        stage1 = mmctm_mod.fit(state1, X, config, maxiter=maxiter, tol=stage1_tol,
                               compact_schedule=compact_schedule)
        if rescore_f64:
            best_m, sel = select_modality_winners_f64(stage1, X, config)
            cand = list(sel["rescored_lanes"])
            winner_ll = [sel["ll_f64"][cand.index(best_m[m]), m] for m in range(config.M)]
        else:
            best_m = pick_optimal_modality_restarts(stage1.ll).cpu().numpy()
            ll32 = stage1.ll.detach().to("cpu", torch.float64).numpy()
            winner_ll = [ll32[best_m[m], m] for m in range(config.M)]
        if selection_info is not None:
            selection_info["stage1_winners"] = np.asarray(best_m)
            selection_info["stage1_winner_ll"] = np.asarray(winner_ll)

        # graft the per-modality winners' topic-word posteriors
        # (run_mmctm.jl:126-130) over fresh inits
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        state2 = mmctm_mod.init_with_alpha(
            gen, config, X, alpha, restarts=stage2_restarts, init_method=init_method,
            device=device,
        )
        def graft(field):
            return tuple(
                field[m][int(best_m[m])].expand(stage2_restarts, *field[m].shape[1:]).clone()
                for m in range(config.M)
            )

        state2 = state2._replace(gamma=graft(stage1.state.gamma),
                                 Elnphi=graft(stage1.state.Elnphi))
        stage2 = mmctm_mod.fit(state2, X, config, maxiter=maxiter, tol=stage2_tol)
        if rescore_f64:
            best, _ = select_best_restart_f64(stage2, X, config)
        else:
            best = int(pick_optimal_restart(stage2.ll))
    return lane(stage2, best), stage1, stage2, best


def two_stage_fit(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                  alpha, restarts: int, stage2_restarts: int = 1, maxiter: int = 1000,
                  stage1_tol: float = 1e-4, stage2_tol: float = 1e-5,
                  init_method: str = "random",
                  compact_schedule: Optional[Sequence[int]] = None,
                  rescore_f64: bool = True, selection_info: Optional[dict] = None,
                  device="cuda"):
    """The reference CLI's two-stage protocol (run_mmctm.jl:163-180) on
    `device`, the CUDA card unless the caller asks for the CPU: `restarts`
    stage-1 lanes initialized as `fit_restarts` initializes them from
    `seed_or_generator`, then `two_stage_fit_from_states`; the stage-2 inits
    come from a CPU generator seeded from a draw of the same generator,
    after the stage-1 inits. Returns (the selected stage-2 lane (R = 1),
    stage-1 result, stage-2 result, selected index)."""
    device = ctm_base.check_device(device)
    gen = _generator(seed_or_generator)
    Xt = mmctm_mod.counts_tensors(X, config, device)
    state1 = mmctm_mod.init_with_alpha(gen, config, Xt, alpha, restarts=restarts,
                                       init_method=init_method, device=device)
    gen2 = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (1,), generator=gen)))
    return two_stage_fit_from_states(
        state1, Xt, config, alpha, stage2_restarts=stage2_restarts, maxiter=maxiter,
        stage1_tol=stage1_tol, stage2_tol=stage2_tol, init_method=init_method,
        compact_schedule=compact_schedule, rescore_f64=rescore_f64, generator=gen2,
        selection_info=selection_info,
    )


def fit_mmctm_restarts(k: Sequence[int], alpha: Sequence[float], X,
                       V: Optional[Sequence[int]] = None, restarts: int = 100,
                       stage2_restarts: int = 1, maxiter: int = 1000,
                       stage1_tol: float = 1e-4, stage2_tol: float = 1e-5,
                       seed: int = 147959412, dtype: torch.dtype = torch.float32,
                       compact_schedule: Optional[Sequence[int]] = None,
                       rescore_f64: bool = True, verbose: bool = False,
                       device="cuda") -> MMCTM:
    """Best-of-N two-stage MMCTM fitting, the reference CLI's `fit_model`
    (run_mmctm.jl:163-180; the JAX package's fit_mmctm_restarts), on
    `device`, the CUDA card unless the caller asks for the CPU. The
    arguments before `restarts` are the `MMCTM` wrapper's (X[doc][modality]
    as (n, 2) 1-based (vocab_index, count) matrices); `compact_schedule`
    compacts stage 1 (`fit_restarts`). Returns that wrapper holding the
    selected stage-2 lane, with `ll_history` (its per-iteration lls),
    `stage1_ll` ((R, M) float64 array of the stage-1 in-fit lls) and
    `restart_result` (the batched stage-1 MMCTMFitResult). `verbose` prints
    the lls the selection read."""
    args = (list(k), list(alpha)) + (() if V is None else (list(V),)) + (X,)
    model = MMCTM(*args, dtype=dtype, device=device)
    selection_info: dict = {}
    best, stage1, _, _ = two_stage_fit(
        seed, model.Xdense, model.config, [float(a) for a in alpha], restarts=restarts,
        stage2_restarts=stage2_restarts, maxiter=maxiter, stage1_tol=stage1_tol,
        stage2_tol=stage2_tol, compact_schedule=compact_schedule, rescore_f64=rescore_f64,
        selection_info=selection_info, device=model.device,
    )
    model.state = best.state
    model.converged = bool(best.converged[0])
    model.elbo = float(best.elbo[0])
    model.ll = [float(v) for v in best.ll[0].cpu()]
    n = int(best.n_iters[0])
    model.ll_history = [[float(v) for v in row] for row in best.ll_history[0, :n].cpu()]
    model.stage1_ll = stage1.ll.detach().to("cpu", torch.float64).numpy()
    model.restart_result = stage1
    if verbose:
        print("Modality optimal model log-likelihoods:")
        for m in range(model.config.M):
            print(f"{m + 1}: {selection_info['stage1_winner_ll'][m]}")
        print("Seeded model log-likelihoods:")
        print(np.asarray(model.ll))
    return model


# ---------------------------------------------------------------------------
# IMMCTM restarts (the unchunked branch of the JAX package's
# fit_immctm_restarts)
# ---------------------------------------------------------------------------


def fit_immctm_restarts_from_states(state: IMMCTMState, X, F, config: IMMCTMConfig,
                                    maxiter: int = 1000, tol: float = 1e-4) -> IMMCTMFitResult:
    """Fit every lane of a batched initial IMMCTM `state` (from
    `immctm.init`, or injected by `interop.immctm_state_from_numpy`). X (dense
    (D, V_m) counts) and F (one-hot (V_m, J_mi) features) are moved to the
    state's device and dtype."""
    device = state.lam.device
    X = mmctm_mod.counts_tensors(X, config, device)
    F = tuple(tuple(torch.as_tensor(f).to(device=device, dtype=config.dtype) for f in Fm)
              for Fm in F)
    return immctm_mod.fit(state, X, F, config, maxiter=maxiter, tol=tol)


def fit_immctm_restarts(k, alpha, features, X, restarts: int = 100, maxiter: int = 1000,
                        tol: float = 1e-4, seed: int = 147959412,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        rescore_f64: bool = True) -> IMMCTM:
    """Best-of-N IMMCTM fitting (the unchunked branch of the JAX package's
    fit_immctm_restarts, restarts.py:1685-1762): `restarts` lanes initialized
    from a CPU generator seeded with `seed`, fit as one batch on `device`
    (the CUDA card unless the caller asks for the CPU), then one lane
    selected by the minimum mean dense rank of |ll| across modalities
    (run_mmctm.jl:136-147), over exact float64 re-scores of every lane's
    final state by default (parallel/rescore.py). The arguments are the
    `IMMCTM` wrapper's. Returns that wrapper holding the selected lane; its
    `restart_result` is the batched IMMCTMFitResult of all lanes."""
    model = IMMCTM(k, alpha, features, X, dtype=dtype, device=device)
    cfg = model.config
    state = immctm_mod.init(torch.Generator().manual_seed(int(seed)), cfg, model.alpha,
                            restarts=restarts, device=model.device)
    result = fit_immctm_restarts_from_states(state, model.Xdense, model.F, cfg,
                                             maxiter=maxiter, tol=tol)
    score = (rescore_immctm_f64(result.state.lam, result.state.gamma, model.Xdense, model.F, cfg)
             if rescore_f64 else result.ll)
    sel = lane(result, int(pick_optimal_restart(score)))
    model.state = sel.state
    model.converged = bool(sel.converged[0])
    model.elbo = float(sel.elbo[0])
    model.ll = [float(v) for v in sel.ll[0].cpu()]
    model.restart_result = result
    return model
