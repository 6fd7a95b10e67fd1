"""Best-of-N restart fitting, with restarts as a leading tensor dimension.

Counterpart of multimodalmusig_tpu/parallel/restarts.py, which replaced the reference's `Distributed.pmap` restart fan-out
(scripts/run_mmctm.jl:99-161) by a `vmap` axis. Here every state tensor
carries the R lanes as its first dimension and one host loop drives them
all (models/ctm_base.run_cavi_from); finished lanes are frozen, so each
lane's trajectory is that of its own single fit.

LDA and ILDA restarts (`fit_lda_restarts`, `fit_ilda_restarts`) keep the
lane with the best final ll, read from float64 re-scores; IMMCTM restarts
the least mean dense rank of |ll|. The MMCTM path is the reference CLI's
two-stage protocol (`fit_mmctm_restarts`, run_mmctm.jl:163-180):
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

One function, `_drive_lanes`, checks and applies the run options of
every fit here. A fit can be cut at boundaries (ctm_base.run_cavi):
`chunk_iters` puts one every chunk_iters iterations, `compact_schedule=(c1,
c2, ...)` at the given budgets, and "auto" at budgets derived from a timed
pilot of the first lanes (`fit_restarts_auto`); at each boundary the
finished lanes leave the batch and `progress` hears how many have finished.

`devices=` on the IMMCTM, LDA and ILDA fitters fans the lanes out over one
process per device instead (parallel/_ranks.py `fit_lanes`; MMCTM's fan-out
is parallel/sharding.py's `shmap_fit_restarts`), uncut, so it excludes
`chunk_iters` and `compact_schedule`.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from functools import partial
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..models import ctm_base
from ..models import ilda as ilda_mod
from ..models import immctm as immctm_mod
from ..models import lda as lda_mod
from ..models import mmctm as mmctm_mod
from ..models.ilda import ILDA, ILDAConfig, ILDAFitResult, ILDAState
from ..models.immctm import IMMCTM, IMMCTMConfig, IMMCTMFitResult, IMMCTMState
from ..models.lda import LDA, LDAConfig, LDAFitResult, LDAState
from ..models.mmctm import MMCTM, MMCTMConfig, MMCTMFitResult, MMCTMState
from ..utils import profiling
from . import _ranks
from .rescore import (
    rescore_ilda_f64,
    rescore_immctm_f64,
    rescore_lda_f64,
    rescore_mmctm_f64,
    shortlist_lanes,
)

__all__ = [
    "dense_rank",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "lane",
    "suggest_compact_schedule",
    "measure_boundary_seconds",
    "auto_compact_schedule",
    "fit_restarts_from_states",
    "fit_restarts",
    "fit_restarts_auto",
    "select_modality_winners_f64",
    "select_best_restart_f64",
    "two_stage_fit_from_states",
    "two_stage_fit",
    "fit_mmctm_restarts",
    "fit_immctm_restarts_from_states",
    "fit_immctm_restarts",
    "fit_lda_restarts_from_states",
    "fit_lda_restarts",
    "fit_ilda_restarts_from_states",
    "fit_ilda_restarts",
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


def _lane_policy(chunk_iters, compact_schedule, devices, auto: bool):
    """`_drive_lanes`' check of its options, before any lane is fit, with
    the JAX package's messages (restarts.py:1304-1312, 1503-1510,
    1572-1577). Returns "auto", or the budgets of ctm_base.run_cavi: every
    `chunk_iters` iterations (an endless repeat), or a `compact_schedule`
    tuple, or None (uncut). `devices` excludes both cuts; with `auto`
    False, "auto" is refused as any other string is."""
    if devices is not None:
        if chunk_iters is not None or compact_schedule:
            raise ValueError(
                "devices (the shard_map restart fan-out) is incompatible "
                "with chunk_iters/compact_schedule (host-driven compaction)"
            )
        return None
    if auto and isinstance(compact_schedule, str):
        if compact_schedule != "auto":
            raise ValueError(f"compact_schedule: expected 'auto' or a tuple, got {compact_schedule!r}")
        if chunk_iters is not None:
            raise ValueError("chunk_iters and compact_schedule='auto' are mutually exclusive")
        return "auto"
    if chunk_iters is not None and compact_schedule is not None:
        raise ValueError("chunk_iters and compact_schedule are mutually exclusive")
    if isinstance(compact_schedule, str):
        raise ValueError(f"compact_schedule: expected a tuple of budgets, got "
                         f"{compact_schedule!r} (fit_restarts_auto derives one)")
    if chunk_iters is None:
        return compact_schedule
    if int(chunk_iters) < 1:
        raise ValueError(f"chunk_iters must be at least 1, got {chunk_iters}")
    return itertools.repeat(int(chunk_iters))


def _sync(device: torch.device):
    """Drain the device's queue (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_BOUNDARY_CACHE: dict = {}


def measure_boundary_seconds(carry, reps: int = 5) -> float:
    """Seconds that one compaction boundary of ctm_base.run_cavi costs
    beyond the lane-iterations it runs, timed on `carry` (a CAVI carry
    (state, ll_buf, n_iters, done), on the fit's device). It times what
    run_cavi does there: the host read of the (n_iters, done) pair, which
    waits for the device; the read of the running lanes' iteration count
    that opens run_cavi_from (`n_iters[~done].unique().tolist()`), another
    wait; and the two gathers (index_select over every carry field, with
    their index vectors sent from the host) that part the finished lanes
    from the survivors, here half and half. The queue is drained before the
    clock starts and before it stops: unsynchronized, the clock would time
    the enqueue only (restarts.py:293-299 of the JAX package). Returns the
    least of `reps` timings."""
    n_iters, done = carry[2], carry[3]
    device = n_iters.device
    pos = np.arange(n_iters.shape[0])
    half = len(pos) // 2
    best = float("inf")
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        n_iters.cpu().numpy(), done.cpu().numpy()
        n_iters[~done].unique().tolist()
        ctm_base._index_lanes(carry, torch.as_tensor(pos[:half], device=device))
        ctm_base._index_lanes(carry, torch.as_tensor(pos[half:], device=device))
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def measure_boundary_seconds_cached(carry, reps: int = 5) -> float:
    """`measure_boundary_seconds` once per device: a boundary's cost is the
    host's round trip to the device more than it is the data, so later
    derivations reuse the first measurement (restarts.py:210-218 of the JAX
    package)."""
    key = str(carry[2].device)
    if key not in _BOUNDARY_CACHE:
        _BOUNDARY_CACHE[key] = measure_boundary_seconds(carry, reps)
    return _BOUNDARY_CACHE[key]


_SCHEDULE_MEMO: dict = {}
_SCHEDULE_MEMO_MAX = 64


def _derive_auto_schedule(iters, t_warm, production_restarts, maxiter, max_boundaries, carry):
    """The schedule of an auto-compacted fit (restarts.py:851-901 of the JAX
    package): the lane-iterations per second of the timed pilot (P lanes
    that ran iters.max() iterations in t_warm seconds), the boundary cost
    measured once per device on the pilot's `carry`, and their product as
    the DP's boundary cost in lane-iterations. Returns (schedule, info).

    The schedule is memoized per pilot iteration counts and DP inputs,
    everything but the measured t_warm: a repeat of the same fit keeps the
    first schedule instead of flipping with the noise of a wall-clock
    measurement. So the first derivation in a process holds for its life,
    and a cold first pilot (kernels loading) pins a schedule derived from
    too low a rate, which prices boundaries too cheap. FIFO-capped at
    _SCHEDULE_MEMO_MAX entries."""
    iters = np.asarray(iters)
    P = int(iters.size)
    sig = (iters.tobytes(), str(iters.dtype), int(production_restarts), int(maxiter),
           int(max_boundaries))
    memo = _SCHEDULE_MEMO.get(sig)
    rate = P * float(iters.max()) / max(t_warm, 1e-9)
    t_boundary = measure_boundary_seconds_cached(carry)
    B = t_boundary * rate
    if memo is not None:
        schedule = memo
    else:
        schedule = tuple(suggest_compact_schedule(
            iters, maxiter=maxiter, boundary_cost_lane_iters=B,
            max_boundaries=max_boundaries, production_restarts=production_restarts,
        ))
        _SCHEDULE_MEMO[sig] = schedule
        while len(_SCHEDULE_MEMO) > _SCHEDULE_MEMO_MAX:
            _SCHEDULE_MEMO.pop(next(iter(_SCHEDULE_MEMO)))
    info = {
        "pilot_restarts": P,
        "pilot_iters_max": int(iters.max()),
        "pilot_iters_median": float(np.median(iters)),
        "pilot_warm_s": t_warm,
        "lane_iters_per_s": rate,
        "boundary_s": t_boundary,
        "boundary_cost_lane_iters": B,
        "schedule": tuple(schedule),
        "schedule_memo_hit": memo is not None,
    }
    return tuple(schedule), info


def _timed_pilot(pilot_fit, device, production_restarts: int, maxiter: int,
                 max_boundaries: int):
    """`pilot_fit()` timed on `device` from a drained queue to the host read
    of its n_iters, then `_derive_auto_schedule` for `production_restarts`
    lanes. Returns (pilot result, schedule, info)."""
    _sync(device)
    t0 = time.perf_counter()
    pilot = pilot_fit()
    iters = pilot.n_iters.cpu().numpy()
    t_warm = time.perf_counter() - t0
    schedule, info = _derive_auto_schedule(
        iters, t_warm, production_restarts, maxiter, max_boundaries,
        (pilot.state, pilot.ll_history, pilot.n_iters, pilot.converged),
    )
    return pilot, schedule, info


def _fit_auto(state, fit_fn, maxiter: int, pilot_restarts: int = 64, max_boundaries: int = 3,
              progress=None):
    """Zero-config compaction with a folded pilot (fit_restarts_auto and
    _family_restarts_auto of the JAX package, restarts.py:904-1057), for
    any family: the first P = max(2, min(pilot_restarts, R // 2)) lanes of
    the batched initial `state` run uncut and timed (`_timed_pilot`), and
    double as the pilot; the other R − P lanes run with the schedule derived
    from them. Nothing is fit twice, and lane i of the result is lane i of
    `state`'s fit. Below 8 lanes it is one uncut fit. `fit_fn(state,
    schedule, progress)` fits a batched state. Returns (result, info)."""
    R, device = ctm_base.lanes_of(state)
    if R < 8:
        result = fit_fn(state, None, progress)
        iters = result.n_iters.cpu().numpy()
        return result, {
            "pilot_restarts": R,
            "pilot_iters_max": int(iters.max()),
            "pilot_iters_median": float(np.median(iters)),
            "pilot_warm_s": 0.0,
            "lane_iters_per_s": 0.0,
            "boundary_s": 0.0,
            "boundary_cost_lane_iters": 0.0,
            "schedule": (),
            "note": "too few restarts to split; single unchunked fit",
        }
    P = max(2, min(int(pilot_restarts), R // 2))
    lanes = torch.arange(R, device=device)
    with profiling.span("restarts.pilot"):
        pilot, schedule, info = _timed_pilot(
            lambda: fit_fn(ctm_base._index_lanes(state, lanes[:P]), None, None), device, R - P,
            maxiter, max_boundaries)
        if progress is not None:
            progress(P, R)
    rest = fit_fn(ctm_base._index_lanes(state, lanes[P:]), schedule,
                  None if progress is None else lambda d, t: progress(P + d, R))
    return ctm_base._cat_lanes([pilot, rest]), info


def _drive_lanes(state, fit, args: tuple, maxiter: int, tol: float, *, chunk_iters=None,
                 compact_schedule=None, auto: bool = True, pilot_restarts: int = 64,
                 max_boundaries: int = 3, devices=None, fan_out=None, progress=None,
                 run_info: Optional[dict] = None):
    """Every restart fitter of every family fits the lanes of its batched
    initial `state` here, by the policy that `_lane_policy` reads from the
    options. `fit(state, *args, maxiter=, tol=, compact_schedule=,
    progress=)` is the family's fit, looked up by the caller at call time.
    With `devices` the lanes fan out, one process per device, each fitting
    its slice uncut with `fan_out`, a module-level `*_from_states` fitter
    (_ranks.fit_lanes, which fills `run_info`), and `progress` hears (R, R)
    at the end; "auto" is `_fit_auto` with TF32 off; else one fit, uncut or
    cut. Returns (result, the "auto" derivation's measurements or None)."""
    policy = _lane_policy(chunk_iters, compact_schedule, devices, auto)
    if devices is not None:
        result = _ranks.fit_lanes(fan_out, state, args, dict(maxiter=maxiter, tol=tol), devices,
                                  run_info)
        if progress is not None:
            R = ctm_base.lanes_of(state)[0]
            progress(R, R)
        return result, None

    def fit_fn(st, schedule, prog):
        return fit(st, *args, maxiter=maxiter, tol=tol, compact_schedule=schedule, progress=prog)

    if isinstance(policy, str):
        with ctm_base.full_f32_matmuls():
            return _fit_auto(state, fit_fn, maxiter, pilot_restarts, max_boundaries, progress)
    return fit_fn(state, policy, progress), None


def fit_restarts_from_states(state: MMCTMState, X, config: MMCTMConfig,
                             maxiter: int = 1000, tol: float = 1e-4,
                             compact_schedule: Optional[Sequence[int]] = None,
                             progress=None) -> MMCTMFitResult:
    """Fit every lane of a batched initial `state` (counterpart of the JAX
    package's fit_restarts_from_keys, with the init handed in: a state from
    `mmctm.init_with_alpha`, or one injected by `interop.state_from_numpy`).
    X is a tuple of dense (D, V_m) counts, moved to the state's device.
    `compact_schedule` (any iterable of budgets) and `progress` as in
    `fit_restarts`."""
    X = mmctm_mod.counts_tensors(X, config, state.lam.device)
    return _drive_lanes(state, mmctm_mod.fit, (X, config), maxiter, tol,
                        compact_schedule=compact_schedule, auto=False, progress=progress)[0]


def _generator(seed_or_generator) -> torch.Generator:
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    return torch.Generator().manual_seed(int(seed_or_generator))


def _init_lanes(seed_or_generator, X, config: MMCTMConfig, alpha, restarts: int,
                init_method: str, device):
    """`restarts` MMCTM lane inits drawn from `seed_or_generator` on `device`,
    as every MMCTM restart fitter draws them, with the dense counts X moved
    there. Returns (X, state)."""
    X = mmctm_mod.counts_tensors(X, config, device)
    return X, mmctm_mod.init_with_alpha(_generator(seed_or_generator), config, X, alpha,
                                        restarts=restarts, init_method=init_method, device=device)


def fit_restarts(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                 alpha, restarts: int, maxiter: int = 1000, tol: float = 1e-4,
                 init_method: str = "random", chunk_iters: Optional[int] = None,
                 compact_schedule: Optional[Sequence[int]] = None, progress=None,
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
    end (`suggest_compact_schedule` picks boundaries, `fit_restarts_auto`
    derives them). `chunk_iters` instead puts a boundary every chunk_iters
    iterations until every lane has finished; the two are mutually
    exclusive. Finished lanes are frozen in every fit, so each lane's result
    equals the unchunked fit's (bit for bit on the CPU; in float32 on the
    card the smaller batches round differently, about 1e-3 on a few lanes'
    ll after hundreds of iterations). The compacted loop is
    ctm_base.run_cavi's.

    `progress(done, total)` hears the number of finished restarts
    (converged, non-finite or at maxiter) at every boundary and at the end;
    an uncut fit calls it once, at the end."""
    X, state = _init_lanes(seed_or_generator, X, config, alpha, restarts, init_method,
                           ctm_base.check_device(device))
    return _drive_lanes(state, mmctm_mod.fit, (X, config), maxiter, tol, chunk_iters=chunk_iters,
                        compact_schedule=compact_schedule, auto=False, progress=progress)[0]


def fit_restarts_auto(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                      alpha, restarts: int, maxiter: int = 1000, tol: float = 1e-4,
                      init_method: str = "random", pilot_restarts: int = 64,
                      max_boundaries: int = 3, progress=None, device="cuda"):
    """Zero-config compacted restart fit (restarts.py:965-1057 of the JAX
    package) on `device`, the CUDA card unless the caller asks for the CPU:
    the R lane inits are drawn once, from the same generator stream as
    `fit_restarts`; the first P = max(2, min(pilot_restarts, R // 2)) lanes
    run uncut and timed, and double as the pilot; the other R − P lanes run
    with the schedule that `suggest_compact_schedule` derives from the
    pilot's iteration counts, its lane-iterations per second and a boundary
    cost measured on this device (`measure_boundary_seconds`). With R < 8 it
    is one uncut fit. Lane i of the result is lane i of `fit_restarts` (to
    the last bit on the CPU; on the card the batches round differently).

    `progress(done, total)` hears (P, R) after the pilot, then the finished
    lanes at each boundary of the rest. Returns (batched MMCTMFitResult over
    all lanes in lane order, info: the derivation's measurements)."""
    X, state = _init_lanes(seed_or_generator, X, config, alpha, restarts, init_method,
                           ctm_base.check_device(device))
    return _drive_lanes(state, mmctm_mod.fit, (X, config), maxiter, tol, compact_schedule="auto",
                        pilot_restarts=pilot_restarts, max_boundaries=max_boundaries,
                        progress=progress)


def auto_compact_schedule(seed_or_generator: Union[int, torch.Generator], X,
                          config: MMCTMConfig, alpha, restarts: int, maxiter: int = 1000,
                          tol: float = 1e-4, pilot_restarts: int = 64,
                          init_method: str = "random", max_boundaries: int = 3,
                          device="cuda"):
    """A compaction schedule for `fit_restarts` from a separate pilot
    (restarts.py:252-309 of the JAX package): max(2, min(pilot_restarts,
    restarts)) lanes, drawn from a generator seeded away from the
    production stream (so the production fit's inits do not change), fit
    and timed on `device`; then `_derive_auto_schedule` for `restarts`
    production lanes. Returns (schedule, info). `fit_restarts_auto` does
    the same work without fitting the pilot twice."""
    device = ctm_base.check_device(device)
    pilot_R = max(2, min(int(pilot_restarts), int(restarts)))
    gen = torch.Generator().manual_seed(_generator(seed_or_generator).initial_seed() ^ 0x9E3779B9)
    X, state = _init_lanes(gen, X, config, alpha, pilot_R, init_method, device)
    _, schedule, info = _timed_pilot(
        lambda: mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol), device,
        int(restarts), maxiter, max_boundaries)
    return schedule, info


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
                              chunk_iters: Optional[int] = None,
                              compact_schedule: Union[Sequence[int], str, None] = None,
                              progress=None, rescore_f64: bool = True, generator=None,
                              pilot_restarts: int = 64, auto_info: Optional[dict] = None,
                              selection_info: Optional[dict] = None):
    """The two-stage protocol (run_mmctm.jl:163-180) from a batched stage-1
    initial state, on its device: stage 1 fits every lane (with
    `compact_schedule`, as `fit_restarts`, or "auto", as
    `fit_restarts_auto` with `pilot_restarts`); the per-modality winners' γ
    and E[ln ϕ] are grafted over `stage2_restarts` fresh inits drawn from
    `generator` (a CPU generator of their own by default) and refit at
    `stage2_tol`; the dense-rank pick chooses among them. Both picks read
    exact float64 re-scores unless `rescore_f64` is False (then the in-fit
    f32 lls). Runs with TF32 off throughout. `chunk_iters` cuts both
    stages, and excludes `compact_schedule` (ValueError).

    `progress(stage, done, total)` hears the finished lanes of stage 1 and
    of stage 2 at each boundary, and at least once per stage, when it ends
    (a stage that runs uncut has no other boundary). `auto_info`, when a
    dict, receives the measurements of an "auto" derivation.
    `selection_info`, when a dict, receives {"stage1_winners" (M,),
    "stage1_winner_ll" (M,)}: the winners and the scores the pick read.
    Returns (the selected stage-2 lane (R = 1), stage-1 result, stage-2
    result, selected index)."""
    progress1, progress2 = (None, None) if progress is None else (partial(progress, 1),
                                                                  partial(progress, 2))
    device = state1.lam.device
    X = mmctm_mod.counts_tensors(X, config, device)
    with ctm_base.full_f32_matmuls():
        stage1, info = _drive_lanes(state1, mmctm_mod.fit, (X, config), maxiter, stage1_tol,
                                    chunk_iters=chunk_iters, compact_schedule=compact_schedule,
                                    pilot_restarts=pilot_restarts, progress=progress1)
        if info is not None and auto_info is not None:
            auto_info.update(info)
        with profiling.span("restarts.rescore1"):
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
        with profiling.span("restarts.graft"):
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
        stage2, _ = _drive_lanes(state2, mmctm_mod.fit, (X, config), maxiter, stage2_tol,
                                 chunk_iters=chunk_iters, progress=progress2)
        with profiling.span("restarts.rescore2"):
            if rescore_f64:
                best, _ = select_best_restart_f64(stage2, X, config)
            else:
                best = int(pick_optimal_restart(stage2.ll))
            selected = lane(stage2, best)
    return selected, stage1, stage2, best


def two_stage_fit(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                  alpha, restarts: int, stage2_restarts: int = 1, maxiter: int = 1000,
                  stage1_tol: float = 1e-4, stage2_tol: float = 1e-5,
                  init_method: str = "random", chunk_iters: Optional[int] = None,
                  compact_schedule: Union[Sequence[int], str, None] = None, progress=None,
                  rescore_f64: bool = True, pilot_restarts: int = 64,
                  auto_info: Optional[dict] = None, selection_info: Optional[dict] = None,
                  device="cuda"):
    """The reference CLI's two-stage protocol (run_mmctm.jl:163-180) on
    `device`, the CUDA card unless the caller asks for the CPU: `restarts`
    stage-1 lanes initialized as `fit_restarts` initializes them from
    `seed_or_generator`, then `two_stage_fit_from_states`, which the other
    options go to; the stage-2 inits come from a CPU generator seeded from a
    draw of the same generator, after the stage-1 inits. Returns (the
    selected stage-2 lane (R = 1), stage-1 result, stage-2 result, selected
    index)."""
    device = ctm_base.check_device(device)
    with profiling.span("restarts.init"):
        gen = _generator(seed_or_generator)
        Xt, state1 = _init_lanes(gen, X, config, alpha, restarts, init_method, device)
        gen2 = torch.Generator().manual_seed(int(torch.randint(0, 2**62, (1,), generator=gen)))
    return two_stage_fit_from_states(
        state1, Xt, config, alpha, stage2_restarts=stage2_restarts, maxiter=maxiter,
        stage1_tol=stage1_tol, stage2_tol=stage2_tol, init_method=init_method,
        chunk_iters=chunk_iters, compact_schedule=compact_schedule, progress=progress,
        rescore_f64=rescore_f64, generator=gen2, pilot_restarts=pilot_restarts,
        auto_info=auto_info, selection_info=selection_info,
    )


def fit_mmctm_restarts(k: Sequence[int], alpha: Sequence[float], X,
                       V: Optional[Sequence[int]] = None, restarts: int = 100,
                       stage2_restarts: int = 1, maxiter: int = 1000,
                       stage1_tol: float = 1e-4, stage2_tol: float = 1e-5,
                       seed: int = 147959412, dtype: torch.dtype = torch.float32,
                       chunk_iters: Optional[int] = None,
                       compact_schedule: Union[Sequence[int], str, None] = None,
                       pilot_restarts: int = 64, progress=None,
                       rescore_f64: bool = True, verbose: bool = False,
                       device="cuda", lambda_extrap: Optional[float] = None,
                       lambda_solver: Optional[str] = None) -> MMCTM:
    """Best-of-N two-stage MMCTM fitting, the reference CLI's `fit_model`
    (run_mmctm.jl:163-180; the JAX package's fit_mmctm_restarts), on
    `device`, the CUDA card unless the caller asks for the CPU. The
    arguments before `restarts` are the `MMCTM` wrapper's (X[doc][modality]
    as (n, 2) 1-based (vocab_index, count) matrices). `compact_schedule`
    compacts stage 1 (`fit_restarts`); "auto" derives its schedule from the
    first `pilot_restarts` lanes (`fit_restarts_auto`) and records the
    derivation as `model.compact_info`. `chunk_iters` cuts both stages;
    `progress(stage, done, total)` hears each stage's finished lanes at its
    boundaries and its end (`two_stage_fit_from_states`). Returns that
    wrapper holding the selected stage-2 lane, with `ll_history` (its
    per-iteration lls), `stage1_ll` ((R, M) float64 array of the stage-1
    in-fit lls) and `restart_result` (the batched stage-1 MMCTMFitResult).
    `verbose` prints the derived schedule and the lls the selection read.
    `lambda_extrap` and `lambda_solver` set the model config's options of
    the λ solve (models/ctm_base.CTMBaseConfig) for both stages.

    An entry point of the tracer (utils/profiling.py): the span
    `restarts.fit` and the counter `restarts.fits`, with the phases
    `restarts.setup` (the wrapper, the dense counts), `restarts.init`,
    `restarts.pilot` ("auto"), `restarts.rescore1`, `restarts.graft`,
    `restarts.rescore2`, `restarts.finalize` (each `mmctm.fit`'s) and
    `restarts.collect` (the selected model to the host)."""
    with profiling.entry("restarts.fit"):
        if profiling.ON:
            profiling.count("restarts.fits")
        with profiling.span("restarts.setup"):
            args = (list(k), list(alpha)) + (() if V is None else (list(V),)) + (X,)
            model = MMCTM(*args, dtype=dtype, device=device)
            model.config = dataclasses.replace(model.config, lambda_extrap=lambda_extrap,
                                               lambda_solver=lambda_solver)
        auto_info: dict = {}
        selection_info: dict = {}
        best, stage1, _, _ = two_stage_fit(
            seed, model.Xdense, model.config, [float(a) for a in alpha], restarts=restarts,
            stage2_restarts=stage2_restarts, maxiter=maxiter, stage1_tol=stage1_tol,
            stage2_tol=stage2_tol, chunk_iters=chunk_iters, compact_schedule=compact_schedule,
            progress=progress, rescore_f64=rescore_f64, pilot_restarts=pilot_restarts,
            auto_info=auto_info, selection_info=selection_info, device=model.device,
        )
        if auto_info:
            model.compact_info = auto_info
            if verbose:
                print(
                    f"auto-compact: schedule={auto_info['schedule']} "
                    f"(pilot = first {auto_info['pilot_restarts']} production "
                    f"lanes, median {auto_info['pilot_iters_median']:.0f} "
                    f"iters; boundary {auto_info['boundary_s'] * 1e3:.3f} ms = "
                    f"{auto_info['boundary_cost_lane_iters']:.0f} lane-iters at "
                    f"{auto_info['lane_iters_per_s']:.0f} lane-iters/s)"
                )
        with profiling.span("restarts.collect"):
            n = ctm_base._take_result(model, best)
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
# One-stage families: fit, score, pick, take (IMMCTM, LDA and ILDA)
# ---------------------------------------------------------------------------


def _fit_best_lane(model, state, fit, args: tuple, fan_out, pick, maxiter: int, tol: float,
                   chunk_iters, compact_schedule, pilot_restarts: int, devices):
    """Best-of-N for IMMCTM, LDA and ILDA: every lane of `state` fit by
    `_drive_lanes`, lane `pick(result)` taken into the wrapper `model` with the
    batched `restart_result`, an "auto" derivation as `compact_info` and a
    fan-out's ranks' run as `rank_info`."""
    rank_info = None if devices is None else {}
    result, compact_info = _drive_lanes(
        state, fit, args, maxiter, tol, chunk_iters=chunk_iters, compact_schedule=compact_schedule,
        pilot_restarts=pilot_restarts, devices=devices, fan_out=fan_out, run_info=rank_info)
    if compact_info is not None:
        model.compact_info = compact_info
    if rank_info is not None:
        model.rank_info = rank_info
    ctm_base._take_result(model, lane(result, pick(result)))
    model.restart_result = result
    return model


def _best_scalar_ll_lane(result, rescore_fn, rescore_f64: bool) -> int:
    """The lane with the best final ll, for the families with one ll per
    lane (restarts.py:1513-1526 of the JAX package): read from exact
    float64 re-scores of the shortlisted lanes (`rescore_fn(lanes)` returns
    their (n,) scores; rescore.shortlist_lanes) unless `rescore_f64` is
    False, then from the in-fit lls. Non-finite lanes are masked either
    way."""
    ll = result.ll.detach().to("cpu", torch.float64).numpy()
    if not rescore_f64:
        return int(np.argmax(np.where(np.isfinite(ll), ll, -np.inf)))
    cand = shortlist_lanes(ll)
    ll64 = rescore_fn(cand).cpu().numpy()
    return int(cand[int(np.argmax(np.where(np.isfinite(ll64), ll64, -np.inf)))])


# ---------------------------------------------------------------------------
# IMMCTM restarts (restarts.py:1685-1762 of the JAX package)
# ---------------------------------------------------------------------------


def fit_immctm_restarts_from_states(state: IMMCTMState, X, F, config: IMMCTMConfig,
                                    maxiter: int = 1000, tol: float = 1e-4,
                                    compact_schedule: Optional[Sequence[int]] = None,
                                    progress=None, devices: Optional[Sequence] = None,
                                    run_info: Optional[dict] = None) -> IMMCTMFitResult:
    """Fit every lane of a batched initial IMMCTM `state` (from
    `immctm.init`, or injected by `interop.immctm_state_from_numpy`). X (dense
    (D, V_m) counts) and F (one-hot (V_m, J_mi) features) are moved to the
    state's device and dtype. `compact_schedule` (any iterable of budgets)
    and `progress` as in `fit_restarts`. `devices` fans the lanes out over
    one process per device, each fitting its slice uncut (the
    result comes back on the state's device, `run_info` receives the ranks'
    backend, timings and launches)."""
    device = state.lam.device
    X = mmctm_mod.counts_tensors(X, config, device)
    F = tuple(tuple(torch.as_tensor(f).to(device=device, dtype=config.dtype) for f in Fm)
              for Fm in F)
    return _drive_lanes(state, immctm_mod.fit, (X, F, config), maxiter, tol,
                        compact_schedule=compact_schedule, auto=False, devices=devices,
                        fan_out=fit_immctm_restarts_from_states, progress=progress,
                        run_info=run_info)[0]


def fit_immctm_restarts(k, alpha, features, X, restarts: int = 100, maxiter: int = 1000,
                        tol: float = 1e-4, seed: int = 147959412,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        rescore_f64: bool = True, chunk_iters: Optional[int] = None,
                        compact_schedule: Union[Sequence[int], str, None] = None,
                        pilot_restarts: int = 64,
                        devices: Optional[Sequence] = None,
                        lambda_extrap: Optional[float] = None,
                        lambda_solver: Optional[str] = None) -> IMMCTM:
    """Best-of-N IMMCTM fitting (the JAX package's fit_immctm_restarts,
    restarts.py:1685-1762): `restarts` lanes initialized
    from a CPU generator seeded with `seed`, fit as one batch on `device`
    (the CUDA card unless the caller asks for the CPU), then one lane
    selected by the minimum mean dense rank of |ll| across modalities
    (run_mmctm.jl:136-147), over exact float64 re-scores of every lane's
    final state by default (parallel/rescore.py). The arguments are the
    `IMMCTM` wrapper's. `chunk_iters` and a `compact_schedule` tuple cut
    the fit as in `fit_restarts`; `compact_schedule="auto"` derives the
    schedule from a pilot of the first `pilot_restarts` lanes, as
    `fit_restarts_auto` does, and records the derivation as
    `model.compact_info`. `devices` fans the lanes out over one process per
    device instead (`fit_immctm_restarts_from_states`), uncut, from the same
    inits, and records the ranks' run as `model.rank_info`; the re-scores
    and the pick stay on `device`. `lambda_extrap` and `lambda_solver` set
    the model config's options of the λ solve (models/ctm_base.CTMBaseConfig).
    Returns that wrapper holding the selected lane; its `restart_result` is
    the batched IMMCTMFitResult of all lanes."""
    model = IMMCTM(k, alpha, features, X, dtype=dtype, device=device)
    model.config = cfg = dataclasses.replace(model.config, lambda_extrap=lambda_extrap,
                                             lambda_solver=lambda_solver)
    state = immctm_mod.init(torch.Generator().manual_seed(int(seed)), cfg, model.alpha,
                            restarts=restarts, device=model.device)

    def pick(result):
        score = (rescore_immctm_f64(result.state.lam, result.state.gamma, model.Xdense, model.F,
                                    cfg) if rescore_f64 else result.ll)
        return int(pick_optimal_restart(score))

    return _fit_best_lane(model, state, immctm_mod.fit, (model.Xdense, model.F, cfg),
                          fit_immctm_restarts_from_states, pick, maxiter, tol, chunk_iters,
                          compact_schedule, pilot_restarts, devices)


# ---------------------------------------------------------------------------
# LDA and ILDA restarts (restarts.py:1496-1682 of the JAX package)
# ---------------------------------------------------------------------------


def fit_lda_restarts_from_states(state: LDAState, X, config: LDAConfig, maxiter: int = 1000,
                                 tol: float = 1e-4,
                                 compact_schedule: Optional[Sequence[int]] = None,
                                 progress=None, devices: Optional[Sequence] = None,
                                 run_info: Optional[dict] = None) -> LDAFitResult:
    """Fit every lane of a batched initial LDA `state` (from `lda.init`, or
    injected by `interop.lda_state_from_numpy`). X, the dense (D, V) counts,
    is moved to the state's device and dtype. `compact_schedule` (any
    iterable of budgets) and `progress` as in `fit_restarts`; `devices` and
    `run_info` as in `fit_immctm_restarts_from_states`."""
    X = lda_mod.counts_tensor(X, config, ctm_base.lanes_of(state)[1])
    return _drive_lanes(state, lda_mod.fit, (X, config), maxiter, tol,
                        compact_schedule=compact_schedule, auto=False, devices=devices,
                        fan_out=fit_lda_restarts_from_states, progress=progress,
                        run_info=run_info)[0]


def fit_lda_restarts(k, alpha, eta, X, V=None, restarts: int = 100, maxiter: int = 1000,
                     tol: float = 1e-4, seed: int = 147959412,
                     dtype: torch.dtype = torch.float32, device="cuda",
                     chunk_iters: Optional[int] = None,
                     compact_schedule: Union[Sequence[int], str, None] = None,
                     rescore_f64: bool = True, pilot_restarts: int = 64,
                     devices: Optional[Sequence] = None) -> LDA:
    """Best-of-N LDA fitting (the JAX package's fit_lda_restarts,
    restarts.py:1529-1605): `restarts` lanes initialized
    from a CPU generator seeded with `seed`, fit as one batch on `device`
    (the CUDA card unless the caller asks for the CPU), then the lane with
    the best final ll, read from exact float64 re-scores of the shortlisted
    lanes by default. The arguments before `restarts` are the `LDA`
    wrapper's. `chunk_iters` and a `compact_schedule` tuple cut the fit as
    in `fit_restarts`; `compact_schedule="auto"` derives the schedule from a
    pilot of the first `pilot_restarts` lanes, as `fit_restarts_auto` does,
    and records the derivation as `model.compact_info`. `devices` fans the
    lanes out as in `fit_immctm_restarts`. Returns that wrapper holding the
    selected lane; its `restart_result` is the batched LDAFitResult of all
    lanes."""
    args = (k, alpha, eta) + (() if V is None else (V,)) + (X,)
    model = LDA(*args, dtype=dtype, device=device)
    state = lda_mod.init(torch.Generator().manual_seed(int(seed)), model.config,
                         restarts=restarts, device=model.device)

    def pick(result):
        return _best_scalar_ll_lane(
            result, lambda lanes: rescore_lda_f64(result.state.gamma, result.state.lam,
                                                  model.Xdense, lanes), rescore_f64)

    return _fit_best_lane(model, state, lda_mod.fit, (model.Xdense, model.config),
                          fit_lda_restarts_from_states, pick, maxiter, tol, chunk_iters,
                          compact_schedule, pilot_restarts, devices)


def fit_ilda_restarts_from_states(state: ILDAState, X, F, config: ILDAConfig,
                                  maxiter: int = 1000, tol: float = 1e-4,
                                  compact_schedule: Optional[Sequence[int]] = None,
                                  progress=None, devices: Optional[Sequence] = None,
                                  run_info: Optional[dict] = None) -> ILDAFitResult:
    """Fit every lane of a batched initial ILDA `state` (from `ilda.init`,
    or injected by `interop.ilda_state_from_numpy`). X (dense (D, V)
    counts) and F (one-hot (V, J_i) features) are moved to the state's
    device and dtype. `compact_schedule` and `progress` as in
    `fit_restarts`; `devices` and `run_info` as in
    `fit_immctm_restarts_from_states`."""
    device = ctm_base.lanes_of(state)[1]
    X = lda_mod.counts_tensor(X, config, device)
    F = tuple(torch.as_tensor(f).to(device=device, dtype=config.dtype) for f in F)
    return _drive_lanes(state, ilda_mod.fit, (X, F, config), maxiter, tol,
                        compact_schedule=compact_schedule, auto=False, devices=devices,
                        fan_out=fit_ilda_restarts_from_states, progress=progress,
                        run_info=run_info)[0]


def fit_ilda_restarts(k, alpha, eta, features, X, restarts: int = 100, maxiter: int = 1000,
                      tol: float = 1e-4, seed: int = 147959412,
                      dtype: torch.dtype = torch.float32, device="cuda",
                      chunk_iters: Optional[int] = None,
                      compact_schedule: Union[Sequence[int], str, None] = None,
                      rescore_f64: bool = True, pilot_restarts: int = 64,
                      devices: Optional[Sequence] = None) -> ILDA:
    """Best-of-N ILDA fitting (the JAX package's fit_ilda_restarts,
    restarts.py:1608-1682), as `fit_lda_restarts`; the
    arguments before `restarts` are the `ILDA` wrapper's. Returns that
    wrapper holding the selected lane; its `restart_result` is the batched
    fit result of all lanes."""
    model = ILDA(k, alpha, eta, features, X, dtype=dtype, device=device)
    state = ilda_mod.init(torch.Generator().manual_seed(int(seed)), model.config,
                          restarts=restarts, device=model.device)

    def pick(result):
        return _best_scalar_ll_lane(
            result, lambda lanes: rescore_ilda_f64(result.state.gamma, result.state.lam,
                                                   model.Xdense, model.F, lanes), rescore_f64)

    return _fit_best_lane(model, state, ilda_mod.fit, (model.Xdense, model.F, model.config),
                          fit_ilda_restarts_from_states, pick, maxiter, tol, chunk_iters,
                          compact_schedule, pilot_restarts, devices)
