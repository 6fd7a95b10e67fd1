"""Multi-Modal Correlated Topic Model (MMCTM) fit by CAVI, in PyTorch.

Counterpart of multimodalmusig_tpu/models/mmctm.py (itself a
re-implementation of the reference's src/MMCTM.jl): a joint logistic-normal
N(μ, Σ) over the concatenated topic space of all modalities with
per-modality Dirichlet topic-word distributions.

Every state tensor carries a leading restart dimension R (a single model is
R = 1): μ (R, MK), Σ/Σ⁻¹ (R, MK, MK), α (R, M), γ/Elnϕ tuples of
(R, K_m, V_m), λ/ν (R, D, MK), ζ (R, D, M). The dense counts X are a tuple
of (D, V_m) tensors shared by all lanes. Nothing here trains by autograd.

The fit's document sums take ctm_base's optional `reduce` hook, with which
parallel/sharding.py fits one model over documents split between processes,
and its vocabulary sums ctm_base's optional `vocab_reduce` hook, with which
it fits one model over vocabularies split between processes.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.solvers import maximize_alpha
from ..ops.special import dirichlet_expectation, gammaln, logmvbeta_symmetric, safe_xlogy, xlogx
from ..utils import graphs, profiling
from ..utils.formatting import infer_vocab_size, sparse_to_dense
from . import ctm_base
from .ctm_base import (
    CTMBaseConfig,
    FrozenTopics,
    _fit_result,
    _take_result,
    calculate_sumtheta,
    check_device,
    counts_per_doc,
    elbo_eta_z_term_dict,
    full_f32_matmuls,
    props_from_lam,
    resolved_budgets,
    run_cavi,
    solve_eta,
    theta_from,
    theta_moments,
    update_Sigma_mats,
    update_mu_vec,
    update_zeta,
)

__all__ = [
    "MMCTMConfig",
    "MMCTMState",
    "MMCTMFitResult",
    "MMCTM",
    "CTM",
    "transform",
    "fit_heldout",
    "predict_modality_eta",
    "counts_tensors",
    "init",
    "init_with_alpha",
    "smoothed_logw",
    "unsmoothed_logw",
    "update_theta",
    "unsmoothed_update_theta",
    "reconstruct_theta",
    "calculate_sumtheta",
    "e_step",
    "e_step_moments",
    "update_mu",
    "update_Sigma",
    "update_gamma",
    "update_alpha",
    "phi_point",
    "props_from",
    "modality_loglikelihoods",
    "doc_modality_loglikelihood",
    "docmodality_loglikelihoods",
    "elbo_terms",
    "calculate_elbo",
    "fit_step_fn",
    "finalize_fit",
    "fit",
    "transform_states",
    "fit_heldout_states",
    "predict_modality_eta_states",
]


class MMCTMConfig(CTMBaseConfig):
    """Static configuration: topic counts and vocab sizes per modality
    (K at src/MMCTM.jl:2, V at src/MMCTM.jl:6)."""


class MMCTMState(NamedTuple):
    """Variational state, field for field the JAX package's MMCTMState with
    a leading restart dimension. θ is not stored: the last E-step's θ is
    softmax(λ_pre + logw_pre), rebuilt by `reconstruct_theta`."""

    mu: torch.Tensor
    Sigma: torch.Tensor
    invSigma: torch.Tensor
    alpha: torch.Tensor
    gamma: Tuple[torch.Tensor, ...]
    Elnphi: Tuple[torch.Tensor, ...]
    lam: torch.Tensor
    nu: torch.Tensor
    zeta: torch.Tensor
    lam_pre: torch.Tensor               # (R, D, MK) λ used by the last θ update
    logw_pre: Tuple[torch.Tensor, ...]  # (R, V_m, K_m) log-weights used then


class MMCTMFitResult(NamedTuple):
    state: MMCTMState
    ll_history: torch.Tensor  # (R, maxiter, M)
    n_iters: torch.Tensor     # (R,)
    converged: torch.Tensor   # (R,)
    elbo: torch.Tensor        # (R,)
    ll: torch.Tensor          # (R, M) final per-modality log-likelihood


def counts_tensors(X, config: MMCTMConfig, device) -> Tuple[torch.Tensor, ...]:
    """Dense (D, V_m) counts (numpy arrays or tensors) as a tuple of tensors
    of the config's dtype on `device`."""
    return tuple(torch.as_tensor(x).to(device=device, dtype=config.dtype) for x in X)


# ---------------------------------------------------------------------------
# Initialization (src/MMCTM.jl:29-91)
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, config: MMCTMConfig, X, restarts: int = 1,
         init_method: str = "random", device="cuda") -> MMCTMState:
    """μ=0, Σ=I, λ=0, ν=1 for `restarts` lanes; γ ~ Uniform{1..100}
    (`random`) or seeded with one distinct document's counts per topic
    (`document`), then consistent ζ (src/MMCTM.jl:47-87), on `device`: the
    CUDA card unless the caller asks for the CPU (without a card a CUDA
    device raises, `ctm_base.check_device`). The random draws come from
    `generator` on its own device and are moved to `device`, so a seed gives
    the same init on every device."""
    device = check_device(device)
    dt, R, D, MK = config.dtype, restarts, config.D, config.MK
    gdev = generator.device
    gamma = []
    for m in range(config.M):
        K, V = config.K[m], config.V[m]
        if init_method == "random":
            g = torch.randint(1, 101, (R, K, V), generator=generator, device=gdev)
            gamma.append(g.to(device=device, dtype=dt))
        elif init_method == "document":
            # one distinct document per topic (replacement only when K > D)
            docs = torch.stack([
                torch.randperm(D, generator=generator, device=gdev)[:K] if K <= D
                else torch.randint(0, D, (K,), generator=generator, device=gdev)
                for _ in range(R)
            ]).to(device)
            gamma.append(1.0 + X[m][docs])
        else:
            raise ValueError("init must be 'random' or 'document'")
    gamma = tuple(gamma)
    lam = torch.zeros((R, D, MK), dtype=dt, device=device)
    nu = torch.ones((R, D, MK), dtype=dt, device=device)
    eye = torch.eye(MK, dtype=dt, device=device).expand(R, MK, MK).clone()
    return MMCTMState(
        mu=torch.zeros((R, MK), dtype=dt, device=device),
        Sigma=eye,
        invSigma=eye.clone(),
        alpha=torch.zeros((R, config.M), dtype=dt, device=device),
        gamma=gamma,
        Elnphi=tuple(dirichlet_expectation(g, axis=-1) for g in gamma),
        lam=lam,
        nu=nu,
        zeta=update_zeta(lam, nu, config),
        # zero log-weights: the uniform 1/K init θ (src/MMCTM.jl:52-58)
        lam_pre=lam,
        logw_pre=tuple(
            torch.zeros((R, config.V[m], config.K[m]), dtype=dt, device=device)
            for m in range(config.M)
        ),
    )


def init_with_alpha(generator, config, X, alpha, restarts: int = 1,
                    init_method: str = "random", device="cuda") -> MMCTMState:
    """init() plus the user's α vector (src/MMCTM.jl:35), on every lane."""
    device = check_device(device)
    state = init(generator, config, X, restarts, init_method, device)
    a = torch.as_tensor(alpha, dtype=config.dtype, device=device)
    return state._replace(alpha=a.expand(restarts, config.M).clone())


# ---------------------------------------------------------------------------
# E-step and M-step (src/MMCTM.jl:110-250)
# ---------------------------------------------------------------------------


def smoothed_logw(state: MMCTMState) -> Tuple[torch.Tensor, ...]:
    """Training log-weights E[ln ϕ] as (R, V_m, K_m) tables (src/MMCTM.jl:183-198)."""
    return tuple(e.mT for e in state.Elnphi)


def unsmoothed_logw(phi) -> Tuple[torch.Tensor, ...]:
    """Inference log-weights ln ϕ from the point estimates (R, K_m, V_m), as
    (R, V_m, K_m) tables (src/MMCTM.jl:496-509)."""
    return tuple(torch.log(p).mT for p in phi)


def update_theta(state: MMCTMState, config: MMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """θ[r,d,v,:] ∝ exp(λ_block[r,d,:] + Elnϕ_m[r,:,v]) (src/MMCTM.jl:183-198)
    as (R, D, V_m, K_m) tensors: θ materialized, for the reference-shaped
    `e_step`; the fit loops take its moments from `theta_moments`."""
    return theta_from(state.lam, smoothed_logw(state), config)


def unsmoothed_update_theta(state: MMCTMState, phi, config: MMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """Inference-mode θ from the point estimates ϕ (R, K_m, V_m)
    (src/MMCTM.jl:496-509), materialized as `update_theta`'s."""
    return theta_from(state.lam, unsmoothed_logw(phi), config)


def reconstruct_theta(state: MMCTMState, config: MMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """The θ of the last E-step, rebuilt from the (λ_pre, logw_pre) snapshot."""
    return theta_from(state.lam_pre, state.logw_pre, config)


def e_step(state: MMCTMState, X, N, config: MMCTMConfig, logw=None):
    """The reference-shaped `fitdoc!` (src/MMCTM.jl:450-455) with θ
    materialized: θ from the pre-update λ and the log-weights `logw` (None:
    E[ln ϕ]), its sums, then `solve_eta` with the previous iteration's λ
    (`lam_pre`, for the config's lambda_extrap). Returns (state, θ tuple of
    (R, D, V_m, K_m)); `e_step_moments` computes the same state without θ."""
    if logw is None:
        logw = smoothed_logw(state)
    theta = theta_from(state.lam, logw, config)
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, calculate_sumtheta(theta, X, config), state.mu, state.invSigma,
        config, lam_prev=state.lam_pre,
    )
    return state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam), theta


def e_step_moments(state: MMCTMState, X, N, config: MMCTMConfig, logw=None,
                   want_scatter: bool = True, vocab_reduce=None):
    """Batched `fitdoc!` (src/MMCTM.jl:450-455) computing only the θ moments
    the CAVI iteration consumes: sumθ for the λ solve and, when
    `want_scatter`, the γ scatter (else None). θ uses the pre-update λ and
    the log-weights `logw` (None: E[ln ϕ], as in a fit; the inference loops
    pass their frozen tables), and both solvers the ζ from the start of the
    E-step, as in the reference; the λ solve's start reads the previous
    iteration's λ (`lam_pre`) when the config's lambda_extrap is set. With
    `vocab_reduce` (ctm_base), sumθ is reduced over the vocabulary slices
    before the η side, which every process then runs on the same bits.
    Returns (state, scatters)."""
    if logw is None:
        logw = smoothed_logw(state)
    sumtheta, scatters = theta_moments(state.lam, logw, X, config, want_scatter, vocab_reduce)
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, sumtheta, state.mu, state.invSigma, config,
        lam_prev=state.lam_pre,
    )
    return (
        state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam),
        scatters,
    )


def update_mu(state: MMCTMState, config: MMCTMConfig = None, reduce=None) -> MMCTMState:
    """μ = mean_d λ_d (src/MMCTM.jl:200-202); with `reduce` (ctm_base), over
    the config's global D."""
    return state._replace(mu=update_mu_vec(state.lam, reduce, None if config is None else config.D))


def update_Sigma(state: MMCTMState, config: MMCTMConfig, reduce=None) -> MMCTMState:
    """Σ = (Σ_d diag(ν_d) + (λ_d-μ)(λ_d-μ)ᵀ) / D, then Σ⁻¹ (src/MMCTM.jl:204-212)."""
    Sigma, invSigma = update_Sigma_mats(state.lam, state.nu, state.mu, config.D, reduce)
    return state._replace(Sigma=Sigma, invSigma=invSigma)


def _gamma_totals(gamma, vocab_reduce=None) -> Tuple[torch.Tensor, ...]:
    """Σ_v γ_m[k, v] of every modality, (R, K_m, 1) each: the normalizer of
    both E[ln ϕ] and ϕ. With `vocab_reduce` (ctm_base), γ holds this
    process's vocabulary slice and the sums are reduced over every slice."""
    totals = [g.sum(dim=-1, keepdim=True) for g in gamma]
    if vocab_reduce is not None:
        totals = vocab_reduce(totals)  # V-reduction: γ's row sums
    return tuple(totals)


def _update_gamma(state: MMCTMState, config: MMCTMConfig, scatter, reduce, vocab_reduce):
    """`update_gamma`, with γ's row sums (`_gamma_totals`) beside the state."""
    if reduce is not None:
        scatter = reduce(list(scatter))  # D-reduction: the γ scatter
    gamma = tuple(state.alpha[:, m, None, None] + scatter[m] for m in range(config.M))
    totals = _gamma_totals(gamma, vocab_reduce)
    Elnphi = tuple(dirichlet_expectation(g, axis=-1, total=t) for g, t in zip(gamma, totals))
    return state._replace(gamma=gamma, Elnphi=Elnphi), totals


def update_gamma(state: MMCTMState, config: MMCTMConfig, scatter, reduce=None) -> MMCTMState:
    """γ_m[k,v] = α_m + Σ_d X_m[d,v]·θ_m[d,v,k] from the E-step's (R, K_m, V_m)
    `scatter`, then E[ln ϕ] (src/MMCTM.jl:224-250, 214-222). With `reduce`,
    the scatters of this process's documents are reduced first."""
    return _update_gamma(state, config, scatter, reduce, None)[0]


def update_alpha(state: MMCTMState, config: MMCTMConfig) -> MMCTMState:
    """Per-modality symmetric Dirichlet MLE of α on every lane
    (src/MMCTM.jl:252-269)."""
    alpha = torch.stack(
        [maximize_alpha(state.alpha[:, m], state.Elnphi[m].sum(dim=(-2, -1)), config.K[m],
                        config.V[m]) for m in range(config.M)],
        dim=-1,
    )
    return state._replace(alpha=alpha)


props_from = props_from_lam


def phi_point(gamma, totals=None) -> Tuple[torch.Tensor, ...]:
    """Point estimate ϕ_m[k, :] = γ_m[k, :] / Σ_v γ (src/MMCTM.jl:244-250).
    `totals`, when given, are those sums (`_gamma_totals`, e.g. reduced over
    the vocabulary slices)."""
    if totals is None:
        totals = _gamma_totals(gamma)
    return tuple(g / t for g, t in zip(gamma, totals))


# ---------------------------------------------------------------------------
# ELBO and log-likelihood (src/MMCTM.jl:271-448)
# ---------------------------------------------------------------------------


def elbo_terms(state: MMCTMState, X, N, config: MMCTMConfig, reduce=None,
               vocab_reduce=None) -> dict:
    """The 7 named ELBO terms of src/MMCTM.jl:271-370, each (R,):
    {ElnPphi, ElnPeta, ElnPZ, ElnPX, ElnQphi, ElnQeta, ElnQZ}. Uses the last
    E-step's θ (reconstructed from the carried snapshot). With `reduce`
    (ctm_base), the document sums are reduced over every process; with
    `vocab_reduce`, the vocabulary sums (sumθ, Σ E[ln ϕ], E[ln p(X)], both
    sums of logmvbeta(γ), (γ−1)·E[ln ϕ] and E[ln q(Z)])."""
    theta = reconstruct_theta(state, config)
    sumtheta = torch.cat(
        [torch.einsum("dv,rdvk->rdk", X[m], theta[m]) for m in range(config.M)], dim=-1
    )
    if vocab_reduce is not None:
        (sumtheta,) = vocab_reduce([sumtheta])  # V-reduction: sumθ of ElnPZ
    terms = elbo_eta_z_term_dict(
        state.lam, state.nu, state.zeta, state.mu, state.invSigma, sumtheta, N, config, reduce
    )
    sums = []  # six vocabulary sums per modality
    for m in range(config.M):
        g, e = state.gamma[m], state.Elnphi[m]
        sums += [e.sum(dim=(-2, -1)), torch.einsum("dv,rdvk,rkv->r", X[m], theta[m], e),
                 gammaln(g).sum(dim=-1), g.sum(dim=-1), ((g - 1.0) * e).sum(dim=(-2, -1)),
                 torch.einsum("dv,rdvk->r", X[m], xlogx(theta[m]))]
    if vocab_reduce is not None:
        sums = vocab_reduce(sums)  # V-reductions: the six sums of every modality
    ElnPphi = ElnPX = ElnQphi = ElnQZ = 0.0
    for m in range(config.M):
        sum_elnphi, elnpx, sum_lgamma, total, gamma_elnphi, elnqz = sums[6 * m:6 * m + 6]
        a = state.alpha[:, m]
        ElnPphi = ElnPphi - config.K[m] * logmvbeta_symmetric(a, config.V[m])
        ElnPphi = ElnPphi + (a - 1.0) * sum_elnphi
        ElnPX = ElnPX + elnpx
        ElnQphi = ElnQphi - (sum_lgamma - gammaln(total)).sum(-1)  # logmvbeta(γ)
        ElnQphi = ElnQphi + gamma_elnphi
        ElnQZ = ElnQZ + elnqz
    if reduce is not None:
        ElnPX, ElnQZ = reduce([ElnPX, ElnQZ])  # D-reductions: E[ln p(X)] and E[ln q(Z)]
    return {
        "ElnPphi": ElnPphi,
        "ElnPeta": terms["ElnPeta"],
        "ElnPZ": terms["ElnPZ"],
        "ElnPX": ElnPX,
        "ElnQphi": ElnQphi,
        "ElnQeta": terms["ElnQeta"],
        "ElnQZ": ElnQZ,
    }


def calculate_elbo(state: MMCTMState, X, N, config: MMCTMConfig, reduce=None,
                   vocab_reduce=None) -> torch.Tensor:
    """The 7-term ELBO with the Blei-Lafferty ζ bound (src/MMCTM.jl:271-382), (R,)."""
    t = elbo_terms(state, X, N, config, reduce, vocab_reduce)
    return (
        t["ElnPphi"] + t["ElnPeta"] + t["ElnPZ"] + t["ElnPX"]
        - t["ElnQphi"] - t["ElnQeta"] - t["ElnQZ"]
    )


def _total_counts(X, vocab_reduce=None) -> Tuple[torch.Tensor, ...]:
    """Σ_d Σ_v X_m of every modality, the lls' denominators; with
    `vocab_reduce` (ctm_base), over every process's vocabulary slice."""
    counts = [Xm.sum() for Xm in X]
    if vocab_reduce is not None:
        counts = vocab_reduce(counts)  # V-reduction: the counts, constant over a fit
    return tuple(counts)


def modality_loglikelihoods(X, props, phi, reduce=None, vocab_reduce=None,
                            counts=None) -> torch.Tensor:
    """(R, M) per-modality per-word mixture log-likelihood:
    Σ_d Σ_v X·log(Σ_k props·ϕ) / Σ_d N_d (src/MMCTM.jl:384-448). With
    `reduce` (ctm_base), both sums are reduced over every process's
    documents. With `vocab_reduce`, X and ϕ hold this process's vocabulary
    slice, the lls' sums are reduced over every slice, and `counts` must be
    the denominators over every slice (`_total_counts`, reduced once per
    fit); without it they default to X's own sums."""
    M = len(X)
    if vocab_reduce is not None and counts is None:
        raise ValueError("a vocab-sharded ll needs the total counts of every slice")
    sums = [safe_xlogy(X[m], props[m] @ phi[m]).sum(dim=(-2, -1)) for m in range(M)]
    counts = [X[m].sum() for m in range(M)] if counts is None else list(counts)
    if reduce is not None:
        both = reduce(sums + counts)  # D-reductions: the lls and the counts
        sums, counts = both[:M], both[M:]
    if vocab_reduce is not None:
        sums = vocab_reduce(sums)  # V-reduction: the lls
    return torch.stack([sums[m] / counts[m] for m in range(M)], dim=-1)


def doc_modality_loglikelihood(Xdm, props, phi) -> torch.Tensor:
    """One document's log-likelihood in one modality over its count N
    (src/MMCTM.jl:384-401): Xdm (V,), props (..., K), phi (..., K, V)."""
    return safe_xlogy(Xdm, (props.unsqueeze(-2) @ phi).squeeze(-2)).sum(-1) / Xdm.sum()


def docmodality_loglikelihoods(X, props, phi) -> torch.Tensor:
    """(R, D, M) per-document per-modality normalized mixture
    log-likelihood, batched (src/MMCTM.jl:384-401). A document with no
    counts in a modality gets NaN there (0/0, the reference's division by
    N_d = 0; `modality_loglikelihoods` skips such documents)."""
    return torch.stack(
        [safe_xlogy(X[m], props[m] @ phi[m]).sum(-1) / X[m].sum(-1) for m in range(len(X))],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Fit (src/MMCTM.jl:457-494)
# ---------------------------------------------------------------------------


def fit_step_fn(X, N, config: MMCTMConfig, autoalpha: bool = False, update_sigma: bool = True,
                reduce=None, vocab_reduce=None):
    """One CAVI iteration as a closure (src/MMCTM.jl:463-479): batched E-step
    (ζ/θ/ν/λ ∀d) → μ → Σ (if update_sigma) → γ → α (if autoalpha) →
    per-modality log-likelihoods. With `reduce` (ctm_base), X and N hold
    this process's documents, the E-step runs on them alone, and μ, Σ, the
    γ scatter and the lls reduce their document sums. With `vocab_reduce`,
    X holds this process's vocabulary slice (N every slice's counts): sumθ,
    γ's row sums (reduced once a step, for both E[ln ϕ] and ϕ) and the lls
    reduce their vocabulary sums; autoα's sums over V are not reduced, so
    it cannot be combined with the hook.

    The step's tail, everything after the E-step, is a chain of small
    PyTorch operations. Inside a fit loop's segment on the card
    (utils/graphs.py) it runs eagerly at the segment's first step, is
    captured as a CUDA graph at its second and replayed after that; the
    E-step and its kernels stay eager. The step then returns the graph's
    buffers, which the next step rewrites. Without a segment (the CPU, a
    direct call), and with either hook, whose collectives stay eager, the
    tail runs eagerly.

    The tracer's span `step` covers the closure, its phases `step.estep`
    (θ moments, η), then, eagerly, `step.mstep` (μ, Σ, Σ⁻¹), `step.gamma`
    (γ, E[ln ϕ], α) and `step.ll`, or, in a graph, `step.tail`."""
    if autoalpha and vocab_reduce is not None:
        raise ValueError("autoalpha is not supported in a vocab-sharded fit")
    counts = None if vocab_reduce is None else _total_counts(X, vocab_reduce)
    graphed = reduce is None and vocab_reduce is None

    def tail(s, scatters, phase=None):
        """μ → Σ, Σ⁻¹ → γ, E[ln ϕ] → α → the lls, from the E-step's state and
        γ scatters; `phase`, the tracer's open phase span, or None."""
        if phase is not None:
            phase = profiling.then(phase, "step.mstep")
        s = update_mu(s, config, reduce)
        if update_sigma:
            s = update_Sigma(s, config, reduce)
        if phase is not None:
            phase = profiling.then(phase, "step.gamma")
        s, totals = _update_gamma(s, config, scatters, reduce, vocab_reduce)
        if autoalpha:
            s = update_alpha(s, config)
        if phase is not None:
            profiling.then(phase, "step.ll")
        ll = modality_loglikelihoods(X, props_from(s.lam, config), phi_point(s.gamma, totals),
                                     reduce, vocab_reduce, counts)
        return s, ll

    def step(s):
        on = profiling.ON
        if on:
            top, phase = profiling.begin("step"), profiling.begin("step.estep")
        s, scatters = e_step_moments(s, X, N, config, vocab_reduce=vocab_reduce)
        graph = graphs.chain("tail", tail, s.lam) if graphed else None
        if graph is not None and graph.warm:
            if on:
                profiling.then(phase, "step.tail")
            s, ll = graph(s, scatters)
        else:
            s, ll = tail(s, scatters, phase if on else None)
            if graph is not None:
                graph.warm = True
        if on:
            profiling.end(top)
        return s, ll

    return step


def finalize_fit(carry, X, N, config: MMCTMConfig, reduce=None,
                 vocab_reduce=None) -> MMCTMFitResult:
    """A finished CAVI carry as an MMCTMFitResult (final ELBO as at
    src/MMCTM.jl:490; with `reduce`, over every process's documents, with
    `vocab_reduce` over every process's vocabulary slice)."""
    return _fit_result(MMCTMFitResult, carry,
                       calculate_elbo(carry[0], X, N, config, reduce, vocab_reduce))


def fit(state: MMCTMState, X, config: MMCTMConfig, maxiter: int = 100,
        tol: float = 1e-4, compact_schedule=(), progress=None, verbose: bool = False,
        autoalpha: bool = False, update_sigma: bool = True, reduce=None,
        vocab_reduce=None) -> MMCTMFitResult:
    """Full MMCTM CAVI over every lane of `state` (src/MMCTM.jl:457-494),
    with TF32 off for all float32 products. X is a tuple of dense (D, V_m)
    tensors on the state's device and dtype. `compact_schedule` (any
    iterable of budgets), `progress(done, total)` and `verbose` are
    ctm_base.run_cavi's; `autoalpha` and `update_sigma` fit_step_fn's.
    `reduce` is ctm_base's data-parallel hook (parallel/sharding.py): the
    state's document fields and X then hold this process's documents.
    `vocab_reduce` is its vocab-sharded hook: γ, E[ln ϕ], logw_pre and X
    then hold this process's vocabulary slice, the config's V stays global.
    The tracer records `finalize_fit` as `restarts.finalize` and adds the
    lanes' Σ n_iters to `loop.lane_iters`, kept on the device."""
    X = tuple(X)
    with full_f32_matmuls():
        N = counts_per_doc(X, vocab_reduce)
        step = fit_step_fn(X, N, config, autoalpha, update_sigma, reduce, vocab_reduce)
        # the loop uses its hook only to agree on `done`, which either hook does
        carry = run_cavi(state, config, maxiter, tol, step, compact_schedule, progress, verbose,
                         reduce=reduce if reduce is not None else vocab_reduce)
        with profiling.span("restarts.finalize"):
            result = finalize_fit(carry, X, N, config, reduce, vocab_reduce)
        if profiling.ON:
            profiling.count("loop.lane_iters", result.n_iters)
        return result


# ---------------------------------------------------------------------------
# Inference with the topics frozen (src/MMCTM.jl:496-634)
# ---------------------------------------------------------------------------


def _frozen_lls(gamma, X, config: MMCTMConfig):
    """The lls of a state under the frozen topics γ, ϕ formed once."""
    phi = phi_point(gamma)
    return lambda s: modality_loglikelihoods(X, props_from(s.lam, config), phi)


FROZEN_TOPICS = FrozenTopics(
    e_step=e_step_moments,
    smoothed_logw=lambda state, config: smoothed_logw(state),
    unsmoothed_logw=lambda gamma, config: unsmoothed_logw(phi_point(gamma)),
    lls=_frozen_lls,
    finalize=finalize_fit,
)


def transform_states(trained: MMCTMState, state: MMCTMState, Xnew, config: MMCTMConfig,
                     maxiter: int = 1000, tol: float = 1e-4, fit_gaussian: bool = False,
                     verbose: bool = False) -> MMCTMFitResult:
    """`ctm_base.transform_states` for MMCTM (src/MMCTM.jl:511-552). Xnew is
    a tuple of dense (D, V_m) tensors on the state's device and dtype."""
    return ctm_base.transform_states(FROZEN_TOPICS, trained, state, Xnew, config, maxiter, tol,
                                     fit_gaussian, verbose)


def fit_heldout_states(trained: MMCTMState, state: MMCTMState, Xheldout, config: MMCTMConfig,
                       maxiter: int = 100, tol: float = 1e-4,
                       verbose: bool = False) -> MMCTMFitResult:
    """`ctm_base.fit_heldout_states` for MMCTM (src/MMCTM.jl:554-586)."""
    return ctm_base.fit_heldout_states(FROZEN_TOPICS, trained, state, Xheldout, config, maxiter,
                                       tol, verbose)


def predict_modality_eta_states(trained: MMCTMState, obs_state: MMCTMState, Xobs, m: int,
                                config: MMCTMConfig, obs_config: MMCTMConfig,
                                maxiter: int = 100, tol: float = 1e-4, verbose: bool = False):
    """`ctm_base.predict_modality_eta_states` for MMCTM
    (src/MMCTM.jl:588-634): 0-based `m` is the held-out modality. Returns
    (η (R, D, K_m), the fitted observed state, converged (R,))."""
    return ctm_base.predict_modality_eta_states(FROZEN_TOPICS, trained, obs_state, Xobs, m,
                                                config, obs_config, maxiter, tol, verbose)


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (src/MMCTM.jl:29-108)
# ---------------------------------------------------------------------------


class MMCTM:
    """Stateful single-model wrapper with the reference's constructor/field
    surface: ``MMCTM(k, α, X)`` or ``MMCTM(k, α, V, X)`` where X[doc][modality]
    is an (n, 2) 1-based (vocab_index, count) matrix. The state is one lane
    (R = 1) on `device`, the CUDA card unless the caller asks for the CPU
    (without a card a CUDA device raises); its γ comes from a CPU generator
    seeded with `seed`. The array fields come back as numpy arrays in the
    reference's layouts, under their names and their Julia spellings."""

    def __init__(self, k, alpha, *args, init: str = "random", seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if len(args) == 2:
            V, X = args
        elif len(args) == 1:
            X = args[0]
            V = [infer_vocab_size([doc[m] for doc in X]) for m in range(len(k))]
        else:
            raise TypeError("MMCTM(k, alpha, [V,] X)")
        if len(alpha) != len(k):
            raise ValueError("alpha must have one entry per modality")
        self.X = [[np.asarray(doc[m]) for m in range(len(k))] for doc in X]
        self.config = MMCTMConfig(
            K=tuple(int(x) for x in k), V=tuple(int(v) for v in V), D=len(X), dtype=dtype
        )
        self.device = check_device(device)
        self.Xdense = counts_tensors(
            [sparse_to_dense([doc[m] for doc in self.X], self.config.V[m])
             for m in range(self.config.M)],
            self.config, self.device,
        )
        self.state = init_with_alpha(
            torch.Generator().manual_seed(seed), self.config, self.Xdense, alpha,
            init_method=init, device=self.device,
        )
        self.converged = False
        self.elbo = None
        self.ll = None

    @property
    def K(self):
        return list(self.config.K)

    @property
    def D(self):
        return self.config.D

    @property
    def M(self):
        return self.config.M

    @property
    def V(self):
        return list(self.config.V)

    @property
    def N(self):
        """N[d][m]: document d's total count in modality m."""
        return [[int(doc[m][:, 1].sum()) if len(doc[m]) else 0 for m in range(self.M)]
                for doc in self.X]

    @property
    def mu(self):
        return self.state.mu[0].cpu().numpy()

    @property
    def Sigma(self):
        return self.state.Sigma[0].cpu().numpy()

    @property
    def invSigma(self):
        return self.state.invSigma[0].cpu().numpy()

    @property
    def alpha(self):
        return [float(a) for a in self.state.alpha[0].cpu()]

    @property
    def props(self):
        """props[d][m]: one document's per-topic proportions (reference layout)."""
        p = [x[0].cpu().numpy() for x in props_from(self.state.lam, self.config)]
        return [[p[m][d] for m in range(self.M)] for d in range(self.D)]

    @property
    def phi(self):
        ph = [x[0].cpu().numpy() for x in phi_point(self.state.gamma)]
        return [[ph[m][k] for k in range(self.config.K[m])] for m in range(self.M)]

    @property
    def gamma(self):
        return [list(g[0].cpu().numpy()) for g in self.state.gamma]

    @property
    def Elnphi(self):
        return [list(e[0].cpu().numpy()) for e in self.state.Elnphi]

    @property
    def lam(self):
        return list(self.state.lam[0].cpu().numpy())

    @property
    def nu(self):
        return list(self.state.nu[0].cpu().numpy())

    @property
    def zeta(self):
        return list(self.state.zeta[0].cpu().numpy())

    @property
    def theta(self):
        """θ[d][m]: (K_m, n_dm) responsibilities over the document's observed
        terms (reference layout), the last E-step's, rebuilt from the carried
        (λ_pre, logw_pre) snapshot."""
        dense = [t[0].cpu().numpy() for t in reconstruct_theta(self.state, self.config)]
        return [[dense[m][d, doc[m][:, 0].astype(np.int64) - 1, :].T for m in range(self.M)]
                for d, doc in enumerate(self.X)]

    # the Julia field names
    μ = mu
    Σ = Sigma
    invΣ = invSigma
    α = alpha
    ϕ = phi
    γ = gamma
    Elnϕ = Elnphi
    λ = lam
    ν = nu
    ζ = zeta
    θ = theta

    def fit(self, maxiter: int = 100, tol: float = 1e-4, verbose: bool = True,
            autoalpha: bool = False, update_sigma: bool = True, **kwargs):
        """`fit!` (src/MMCTM.jl:457-494), resuming from the current state.
        Returns the per-iteration list of per-modality log-likelihoods.
        `verbose` (the default, as in the reference) prints the inner-solver
        budgets the fit resolved and each iteration's lls. Accepts the Julia
        keyword spellings autoα and updateΣ."""
        autoalpha, update_sigma = _fit_options(self.config, verbose, autoalpha, update_sigma,
                                               kwargs)
        result = fit(self.state, self.Xdense, self.config, maxiter=maxiter, tol=tol,
                     verbose=verbose, autoalpha=autoalpha, update_sigma=update_sigma)
        n = _take_result(self, result)
        return [[float(v) for v in row] for row in result.ll_history[0, :n].cpu()]

    fit_ = fit

    def __repr__(self):
        status = (
            f"fitted, ll={[round(v, 5) for v in self.ll]}" if self.ll is not None else "unfitted"
        )
        return f"MMCTM(K={self.K}, D={self.D}, V={self.V}, {status})"


def _fit_options(config, verbose, autoalpha, update_sigma, kwargs):
    """A wrapper fit's (autoalpha, update_sigma), the Julia spellings autoα
    and updateΣ in `kwargs` taking precedence; any other keyword raises.
    `verbose` prints the inner-solver budgets the fit resolves (float32
    fits take the warm-start caps)."""
    autoalpha = kwargs.pop("autoα", autoalpha)
    update_sigma = kwargs.pop("updateΣ", update_sigma)
    if kwargs:
        raise TypeError(f"unexpected kwargs: {sorted(kwargs)}")
    if verbose:
        print(f"inner-solver budgets: {resolved_budgets(config)}")
    return autoalpha, update_sigma


class CTM(MMCTM):
    """Single-modality MMCTM, the classic correlated topic model
    (reference README.md:67-73): ``CTM(k, α, X)`` or ``CTM(k, α, V, X)``
    with X from `format_counts_ctm`."""

    def __init__(self, k: int, alpha: float, *args, **kwargs):
        if len(args) == 2:
            V, X = args
            V = [V] if isinstance(V, int) else list(V)
            super().__init__([k], [alpha], V, X, **kwargs)
        elif len(args) == 1:
            super().__init__([k], [alpha], args[0], **kwargs)
        else:
            raise TypeError("CTM(k, alpha, [V,] X) with X from format_counts_ctm")


def transform(model: MMCTM, X, maxiter: int = 1000, tol: float = 1e-4,
              fit_gaussian: bool = False, verbose: bool = False) -> MMCTM:
    """`transform(model, X)` (src/MMCTM.jl:511-552): a new fitted MMCTM over
    the documents X with the model's topics frozen, on the model's device
    and dtype. As in the JAX package, tol defaults to 1e-4 (the reference's
    typo is 1e4) and, unless `fit_gaussian`, the new model keeps the
    trained μ, Σ and Σ⁻¹ (test/mmctm.jl:390-404)."""
    newmodel = MMCTM(model.K, model.alpha, model.V, X, dtype=model.config.dtype,
                     device=model.device)
    result = transform_states(model.state, newmodel.state, newmodel.Xdense, newmodel.config,
                              maxiter=maxiter, tol=tol, fit_gaussian=fit_gaussian,
                              verbose=verbose)
    _take_result(newmodel, result)
    if not fit_gaussian:
        newmodel.state = newmodel.state._replace(
            mu=model.state.mu, Sigma=model.state.Sigma, invSigma=model.state.invSigma
        )
    return newmodel


def fit_heldout(Xheldout, model: MMCTM, maxiter: int = 100, verbose: bool = False) -> MMCTM:
    """`fit_heldout(Xheldout, model)` (src/MMCTM.jl:554-586): a new MMCTM
    over the held-out documents with the model's global posterior, its lls
    the held-out per-word log-likelihoods; on the model's device and dtype."""
    heldout = MMCTM(model.K, model.alpha, model.V, Xheldout, dtype=model.config.dtype,
                    device=model.device)
    _take_result(heldout, fit_heldout_states(model.state, heldout.state, heldout.Xdense,
                                             heldout.config, maxiter=maxiter, verbose=verbose))
    return heldout


def _observed(model, m: int):
    """The 0-based held-out modality and the observed ones of a 1-based `m`."""
    if not 1 <= m <= model.M:
        raise ValueError(f"m must be a 1-based modality index in 1..{model.M}, got {m}")
    if model.M < 2:
        raise ValueError("predict_modality_eta needs at least two modalities")
    return m - 1, [i for i in range(model.M) if i != m - 1]


def _eta_list(eta, converged):
    """η of lane 0 as one array per document, with the reference's warning
    when the observed fit did not converge."""
    if not bool(converged[0]):
        warnings.warn("model not converged.")
    eta = eta[0].cpu().numpy()
    return [eta[d] for d in range(eta.shape[0])]


def predict_modality_eta(Xobs, m: int, model: MMCTM, maxiter: int = 100,
                         verbose: bool = False):
    """`predict_modality_η(Xobs, m, model)` (src/MMCTM.jl:588-634): `m` is
    the 1-based modality to predict, Xobs[doc] holds the other modalities
    in their order. Returns one η array (length K[m]) per document."""
    m0, obsM = _observed(model, m)
    obs_model = MMCTM([model.K[i] for i in obsM], [model.alpha[i] for i in obsM],
                      [model.V[i] for i in obsM], Xobs, dtype=model.config.dtype,
                      device=model.device)
    eta, _, converged = predict_modality_eta_states(
        model.state, obs_model.state, obs_model.Xdense, m0, model.config, obs_model.config,
        maxiter=maxiter, verbose=verbose,
    )
    return _eta_list(eta, converged)
