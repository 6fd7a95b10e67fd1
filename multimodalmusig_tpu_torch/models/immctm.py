"""Independent-feature Multi-Modal CTM (IMMCTM) fit by CAVI, in PyTorch.

Counterpart of multimodalmusig_tpu/models/immctm.py (itself a
re-implementation of the reference's src/IMMCTM.jl): MMCTM's joint
logistic-normal over all modalities' topics, with feature-factorized
topic-word distributions p_m(v|k) = Π_i ϕ_m,k,i[features_m[v,i]] and a
Dirichlet hyperparameter α[m][i] per modality and feature
(src/IMMCTM.jl:13, 22). Each feature lookup is a one-hot matrix F_m,i
(V_m, J_mi) (models/ilda.feature_onehots), so the reference's nested loops
(src/IMMCTM.jl:152-172, 199-223) become matrix products. The document side
is ctm_base's E-step, shared with MMCTM: the feature product is summed into
a (V_m, K_m) log-weight table before the θ moments, so both families launch
the same θ and λ kernels.

Every state tensor carries a leading restart dimension R (a single model is
R = 1): μ (R, MK), Σ/Σ⁻¹ (R, MK, MK), α a tuple of (R, I_m), γ/Elnϕ nested
tuples [m][i] of (R, K_m, J_mi), λ/ν (R, D, MK), ζ (R, D, M). The counts X
(a tuple of (D, V_m)) and the one-hots F ([m][i] of (V_m, J_mi)) are shared
by every lane.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.solvers import maximize_alpha
from ..ops.special import dirichlet_expectation, logmvbeta, logmvbeta_symmetric, safe_xlogy, xlogx
from ..utils.formatting import sparse_to_dense
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
    run_cavi,
    solve_eta,
    theta_from,
    theta_moments,
    update_mu_Sigma,
    update_zeta,
)
from .ilda import feature_onehots
from .mmctm import (
    _eta_list,
    _fit_options,
    _observed,
    counts_tensors,
)

__all__ = [
    "IMMCTMConfig",
    "IMMCTMState",
    "IMMCTMFitResult",
    "IMMCTM",
    "transform",
    "fit_heldout",
    "predict_modality_eta",
    "init",
    "summed_Elnphi",
    "smoothed_logw",
    "unsmoothed_logw",
    "update_theta",
    "reconstruct_theta",
    "e_step",
    "e_step_moments",
    "update_gamma",
    "update_alpha",
    "phi_point",
    "vocab_topic_probs",
    "modality_loglikelihoods",
    "docmodality_loglikelihoods",
    "calculate_elbo",
    "fit_step_fn",
    "finalize_fit",
    "fit",
    "transform_states",
    "fit_heldout_states",
    "predict_modality_eta_states",
]


@dataclasses.dataclass(frozen=True)
class IMMCTMConfig(CTMBaseConfig):
    """CTMBaseConfig plus the feature structure: J[m][i] values of feature i
    of modality m."""

    J: Tuple[Tuple[int, ...], ...] = ()

    @property
    def I(self) -> Tuple[int, ...]:
        return tuple(len(j) for j in self.J)


class IMMCTMState(NamedTuple):
    """Variational state, field for field the JAX package's IMMCTMState with
    a leading restart dimension. γ/Elnϕ are (R, K_m, J_mi) per (m, i): the
    reference's [m][k][i][j] nesting (src/IMMCTM.jl:19-20) as matrices."""

    mu: torch.Tensor
    Sigma: torch.Tensor
    invSigma: torch.Tensor
    alpha: Tuple[torch.Tensor, ...]                 # per modality (R, I_m)
    gamma: Tuple[Tuple[torch.Tensor, ...], ...]     # [m][i] (R, K_m, J_mi)
    Elnphi: Tuple[Tuple[torch.Tensor, ...], ...]    # [m][i] (R, K_m, J_mi)
    lam: torch.Tensor
    nu: torch.Tensor
    zeta: torch.Tensor
    lam_pre: torch.Tensor                           # λ used by the last θ update
    logw_pre: Tuple[torch.Tensor, ...]              # (R, V_m, K_m) Σ_i Elnϕ then


class IMMCTMFitResult(NamedTuple):
    state: IMMCTMState
    ll_history: torch.Tensor  # (R, maxiter, M)
    n_iters: torch.Tensor     # (R,)
    converged: torch.Tensor   # (R,)
    elbo: torch.Tensor        # (R,)
    ll: torch.Tensor          # (R, M) final per-modality log-likelihood


# ---------------------------------------------------------------------------
# Initialization (src/IMMCTM.jl:30-88)
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, config: IMMCTMConfig, alpha, restarts: int = 1,
         device="cuda") -> IMMCTMState:
    """γ_m,i ~ Uniform{1..100}, μ=0, Σ=I, λ=0, ν=1 for `restarts` lanes
    (src/IMMCTM.jl:47-83) on `device`, the CUDA card unless the caller asks
    for the CPU (without a card a CUDA device raises); `alpha[m]` holds
    modality m's I_m values. The draws come from `generator` on its own
    device and are moved to `device`, so a seed gives the same init on
    every device."""
    device = check_device(device)
    dt, R, D, MK = config.dtype, restarts, config.D, config.MK
    gdev = generator.device
    gamma = tuple(
        tuple(
            torch.randint(1, 101, (R, config.K[m], config.J[m][i]), generator=generator,
                          device=gdev).to(device=device, dtype=dt)
            for i in range(config.I[m])
        )
        for m in range(config.M)
    )
    lam = torch.zeros((R, D, MK), dtype=dt, device=device)
    nu = torch.ones((R, D, MK), dtype=dt, device=device)
    eye = torch.eye(MK, dtype=dt, device=device).expand(R, MK, MK).clone()
    return IMMCTMState(
        mu=torch.zeros((R, MK), dtype=dt, device=device),
        Sigma=eye,
        invSigma=eye.clone(),
        alpha=tuple(
            torch.as_tensor([float(a) for a in am], dtype=dt, device=device)
            .expand(R, config.I[m]).clone()
            for m, am in enumerate(alpha)
        ),
        gamma=gamma,
        Elnphi=tuple(tuple(dirichlet_expectation(g, axis=-1) for g in gm) for gm in gamma),
        lam=lam,
        nu=nu,
        zeta=update_zeta(lam, nu, config),
        # zero log-weights: the uniform 1/K init θ (src/IMMCTM.jl:52-58)
        lam_pre=lam,
        logw_pre=tuple(
            torch.zeros((R, config.V[m], config.K[m]), dtype=dt, device=device)
            for m in range(config.M)
        ),
    )


# ---------------------------------------------------------------------------
# E-step and M-step (src/IMMCTM.jl:90-244, 430-435)
# ---------------------------------------------------------------------------


def summed_Elnphi(Elnphi_m: Sequence[torch.Tensor], F_m: Sequence[torch.Tensor]) -> torch.Tensor:
    """(R, V_m, K_m): Σ_i Elnϕ_m,i[k, features[v, i]] as one-hot products
    (replaces the k×w×i loop at src/IMMCTM.jl:152-172)."""
    total = F_m[0] @ Elnphi_m[0].mT
    for i in range(1, len(F_m)):
        total = total + F_m[i] @ Elnphi_m[i].mT
    return total


def smoothed_logw(state: IMMCTMState, F, config: IMMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """Training log-weights Σ_i E[ln ϕ] as (R, V_m, K_m) tables
    (src/IMMCTM.jl:152-172)."""
    return tuple(summed_Elnphi(state.Elnphi[m], F[m]) for m in range(config.M))


def unsmoothed_logw(phi, F, config: IMMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """Inference log-weights Σ_i ln ϕ from the point estimates, as
    (R, V_m, K_m) tables: MMCTM's unsmoothed θ for the feature-factorized
    model."""
    return tuple(summed_Elnphi(tuple(torch.log(p) for p in phi[m]), F[m])
                 for m in range(config.M))


def update_theta(state: IMMCTMState, F, config: IMMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """θ[r,d,v,:] ∝ exp(λ_block[r,d,:] + Σ_i Elnϕ) (src/IMMCTM.jl:152-172) as
    (R, D, V_m, K_m) tensors, for the reference-shaped `e_step`."""
    return theta_from(state.lam, smoothed_logw(state, F, config), config)


def reconstruct_theta(state: IMMCTMState, config: IMMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """The θ of the last E-step, rebuilt from the (λ_pre, logw_pre) snapshot."""
    return theta_from(state.lam_pre, state.logw_pre, config)


def e_step(state: IMMCTMState, X, N, F, config: IMMCTMConfig, logw=None):
    """The reference-shaped `fitdoc!` (src/IMMCTM.jl:430-435) with θ
    materialized, as mmctm.e_step: θ from the log-weights `logw` (None: the
    smoothed Σ_i E[ln ϕ]), then `solve_eta` with `lam_pre`. Returns (state,
    θ tuple of (R, D, V_m, K_m))."""
    if logw is None:
        logw = smoothed_logw(state, F, config)
    theta = theta_from(state.lam, logw, config)
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, calculate_sumtheta(theta, X, config), state.mu, state.invSigma,
        config, lam_prev=state.lam_pre,
    )
    return state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam), theta


def e_step_moments(state: IMMCTMState, X, N, F, config: IMMCTMConfig, logw=None,
                   want_scatter: bool = True):
    """Batched `fitdoc!` (src/IMMCTM.jl:430-435) computing only the θ moments
    the CAVI iteration consumes, through the shared ctm_base.theta_moments
    and solve_eta. θ takes the log-weights `logw` (None: the smoothed
    Σ_i E[ln ϕ]); the λ solve's start reads `lam_pre` when the config's
    lambda_extrap is set. Returns (state, scatters tuple of (R, K_m, V_m),
    or None without `want_scatter`)."""
    if logw is None:
        logw = smoothed_logw(state, F, config)
    sumtheta, scatters = theta_moments(state.lam, logw, X, config, want_scatter)
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, sumtheta, state.mu, state.invSigma, config,
        lam_prev=state.lam_pre,
    )
    return (
        state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam),
        scatters,
    )


def update_gamma(state: IMMCTMState, F, config: IMMCTMConfig, scatter) -> IMMCTMState:
    """γ_m,i = α_m,i + scatter_m @ F_m,i from the E-step's (R, K_m, V_m)
    count-weighted θ sums, then E[ln ϕ] (src/IMMCTM.jl:199-223)."""
    gamma = tuple(
        tuple(state.alpha[m][:, i, None, None] + scatter[m] @ F[m][i]
              for i in range(config.I[m]))
        for m in range(config.M)
    )
    return state._replace(
        gamma=gamma,
        Elnphi=tuple(tuple(dirichlet_expectation(g, axis=-1) for g in gm) for gm in gamma),
    )


def update_alpha(state: IMMCTMState, config: IMMCTMConfig) -> IMMCTMState:
    """Symmetric Dirichlet MLE of α per modality and feature, on every lane
    (src/IMMCTM.jl:225-244)."""
    alpha = tuple(
        torch.stack([maximize_alpha(state.alpha[m][:, i], state.Elnphi[m][i].sum(dim=(-2, -1)),
                                    config.K[m], config.J[m][i])
                     for i in range(config.I[m])], dim=-1)
        for m in range(config.M)
    )
    return state._replace(alpha=alpha)


def phi_point(gamma) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """ϕ_m,i[k, :] = γ_m,i[k, :] normalized over values (src/IMMCTM.jl:440-449)."""
    return tuple(tuple(g / g.sum(dim=-1, keepdim=True) for g in gm) for gm in gamma)


def vocab_topic_probs(phi_m: Sequence[torch.Tensor], F_m: Sequence[torch.Tensor]) -> torch.Tensor:
    """(R, K_m, V_m): p(v|k) = Π_i ϕ_m,k,i[features[v, i]] (src/IMMCTM.jl:362-386)."""
    return torch.exp(summed_Elnphi(tuple(torch.log(p) for p in phi_m), F_m)).mT


# ---------------------------------------------------------------------------
# ELBO and log-likelihood (src/IMMCTM.jl:247-428)
# ---------------------------------------------------------------------------


def modality_loglikelihoods(X, lam, gamma, F, config: IMMCTMConfig) -> torch.Tensor:
    """(R, M) per-modality per-word mixture log-likelihood with props =
    softmax(λ block) and ϕ normalized from γ (src/IMMCTM.jl:388-428)."""
    props = props_from_lam(lam, config)
    phi = phi_point(gamma)
    return torch.stack(
        [safe_xlogy(X[m], props[m] @ vocab_topic_probs(phi[m], F[m])).sum(dim=(-2, -1))
         / X[m].sum()
         for m in range(config.M)],
        dim=-1,
    )


def docmodality_loglikelihoods(X, lam, gamma, F, config: IMMCTMConfig) -> torch.Tensor:
    """(R, D, M) per-document per-modality normalized log-likelihood
    (src/IMMCTM.jl:362-386), batched; NaN for a document with no counts in
    a modality (as mmctm.docmodality_loglikelihoods)."""
    props = props_from_lam(lam, config)
    phi = phi_point(gamma)
    return torch.stack(
        [safe_xlogy(X[m], props[m] @ vocab_topic_probs(phi[m], F[m])).sum(-1) / X[m].sum(-1)
         for m in range(config.M)],
        dim=-1,
    )


def calculate_elbo(state: IMMCTMState, X, N, F, config: IMMCTMConfig) -> torch.Tensor:
    """The 7-term ELBO, MMCTM's with per-feature Dirichlet terms
    (src/IMMCTM.jl:247-360), (R,). Uses the last E-step's θ (reconstructed
    from the carried snapshot)."""
    theta = reconstruct_theta(state, config)
    sumtheta = torch.cat(
        [torch.einsum("dv,rdvk->rdk", X[m], theta[m]) for m in range(config.M)], dim=-1
    )
    t = elbo_eta_z_term_dict(
        state.lam, state.nu, state.zeta, state.mu, state.invSigma, sumtheta, N, config
    )
    ElnPphi = ElnPX = ElnQphi = ElnQZ = 0.0
    for m in range(config.M):
        for i in range(config.I[m]):
            a = state.alpha[m][:, i]
            ElnPphi = ElnPphi - config.K[m] * logmvbeta_symmetric(a, config.J[m][i])
            ElnPphi = ElnPphi + (a - 1.0) * state.Elnphi[m][i].sum(dim=(-2, -1))
            ElnQphi = ElnQphi - logmvbeta(state.gamma[m][i], axis=-1).sum(-1)
            ElnQphi = ElnQphi + ((state.gamma[m][i] - 1.0) * state.Elnphi[m][i]).sum(dim=(-2, -1))
        ElnPX = ElnPX + torch.einsum(
            "dv,rdvk,rvk->r", X[m], theta[m], summed_Elnphi(state.Elnphi[m], F[m])
        )
        ElnQZ = ElnQZ + torch.einsum("dv,rdvk->r", X[m], xlogx(theta[m]))
    eta_z = t["ElnPeta"] + t["ElnPZ"] - t["ElnQeta"]
    return ElnPphi + eta_z + ElnPX - ElnQphi - ElnQZ


# ---------------------------------------------------------------------------
# Fit (src/IMMCTM.jl:437-466)
# ---------------------------------------------------------------------------


def fit_step_fn(X, N, F, config: IMMCTMConfig, autoalpha: bool = False,
                update_sigma: bool = True):
    """One CAVI iteration as a closure (src/IMMCTM.jl:441-451): batched
    E-step (ζ/θ/ν/λ ∀d) → μ → Σ (if update_sigma) → γ → α (if autoalpha)
    → per-modality log-likelihoods."""

    def step(s):
        s, scatters = e_step_moments(s, X, N, F, config)
        s = update_gamma(update_mu_Sigma(s, config, update_sigma), F, config, scatters)
        if autoalpha:
            s = update_alpha(s, config)
        return s, modality_loglikelihoods(X, s.lam, s.gamma, F, config)

    return step


def finalize_fit(carry, X, N, F, config: IMMCTMConfig) -> IMMCTMFitResult:
    """A finished CAVI carry as an IMMCTMFitResult (final ELBO as at
    src/IMMCTM.jl:463)."""
    return _fit_result(IMMCTMFitResult, carry, calculate_elbo(carry[0], X, N, F, config))


def fit(state: IMMCTMState, X, F, config: IMMCTMConfig, maxiter: int = 100,
        tol: float = 1e-4, compact_schedule=(), progress=None, verbose: bool = False,
        autoalpha: bool = False, update_sigma: bool = True) -> IMMCTMFitResult:
    """Full IMMCTM CAVI over every lane of `state` (src/IMMCTM.jl:437-466),
    with TF32 off for all float32 products. X (dense (D, V_m)) and F (one-hot
    (V_m, J_mi)) are tensors on the state's device and dtype.
    `compact_schedule` (any iterable of budgets), `progress(done, total)`
    and `verbose` are ctm_base.run_cavi's; `autoalpha` and `update_sigma`
    fit_step_fn's."""
    X = tuple(X)
    with full_f32_matmuls():
        N = counts_per_doc(X)
        step = fit_step_fn(X, N, F, config, autoalpha, update_sigma)
        carry = run_cavi(state, config, maxiter, tol, step, compact_schedule, progress, verbose)
        return finalize_fit(carry, X, N, F, config)


# ---------------------------------------------------------------------------
# Inference with the topics frozen (src/IMMCTM.jl:468-545)
# ---------------------------------------------------------------------------


def frozen_topics(F) -> FrozenTopics:
    """IMMCTM's part of the inference loops, with the one-hot features F of
    the modalities the loop fits."""
    return FrozenTopics(
        e_step=lambda s, X, N, config, **kw: e_step_moments(s, X, N, F, config, **kw),
        smoothed_logw=lambda state, config: smoothed_logw(state, F, config),
        unsmoothed_logw=lambda gamma, config: unsmoothed_logw(phi_point(gamma), F, config),
        lls=lambda gamma, X, config: (
            lambda s: modality_loglikelihoods(X, s.lam, s.gamma, F, config)),
        finalize=lambda carry, X, N, config: finalize_fit(carry, X, N, F, config),
    )


def transform_states(trained: IMMCTMState, state: IMMCTMState, Xnew, F, config: IMMCTMConfig,
                     maxiter: int = 1000, tol: float = 1e-4, fit_gaussian: bool = False,
                     verbose: bool = False) -> IMMCTMFitResult:
    """`ctm_base.transform_states` for IMMCTM, θ from the frozen Σ_i ln ϕ
    (the reference has no IMMCTM transform; the JAX package's extension)."""
    return ctm_base.transform_states(frozen_topics(F), trained, state, Xnew, config, maxiter,
                                     tol, fit_gaussian, verbose)


def fit_heldout_states(trained: IMMCTMState, state: IMMCTMState, Xheldout, F,
                       config: IMMCTMConfig, maxiter: int = 100, tol: float = 1e-4,
                       verbose: bool = False) -> IMMCTMFitResult:
    """`ctm_base.fit_heldout_states` for IMMCTM (src/IMMCTM.jl:468-497)."""
    return ctm_base.fit_heldout_states(frozen_topics(F), trained, state, Xheldout, config,
                                       maxiter, tol, verbose)


def predict_modality_eta_states(trained: IMMCTMState, obs_state: IMMCTMState, Xobs, m: int,
                                Fobs, config: IMMCTMConfig, obs_config: IMMCTMConfig,
                                maxiter: int = 100, tol: float = 1e-4, verbose: bool = False):
    """`ctm_base.predict_modality_eta_states` for IMMCTM
    (src/IMMCTM.jl:499-545), with the observed modalities' one-hot
    features `Fobs`. Returns (η (R, D, K_m), the fitted observed state,
    converged (R,))."""
    return ctm_base.predict_modality_eta_states(frozen_topics(Fobs), trained, obs_state, Xobs,
                                                m, config, obs_config, maxiter, tol, verbose)


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (src/IMMCTM.jl:30-88)
# ---------------------------------------------------------------------------


class IMMCTM:
    """Stateful single-model wrapper with the reference's constructor/field
    surface: ``IMMCTM(k, α, features, X)`` where α[m] is a scalar (broadcast
    over the modality's features, src/IMMCTM.jl:80-88) or one value per
    feature, `features[m]` is a (V_m, I_m) table of 1-based feature values
    and X[doc][modality] an (n, 2) 1-based (vocab_index, count) matrix. The
    state is one lane (R = 1) on `device`, the CUDA card unless the caller
    asks for the CPU (without a card a CUDA device raises); its γ comes from
    a CPU generator seeded with `seed`."""

    def __init__(self, k, alpha, features, X, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        self.features = [np.asarray(f) for f in features]
        M = len(self.features)
        if len(k) != M or len(alpha) != M:
            raise ValueError("k and alpha must have one entry per modality")
        J = tuple(tuple(int(f[:, i].max()) for i in range(f.shape[1])) for f in self.features)
        full_alpha = [
            [float(v) for v in a] if np.ndim(a) > 0 else [float(a)] * len(J[m])
            for m, a in enumerate(alpha)
        ]
        self.X = [[np.asarray(doc[m]) for m in range(M)] for doc in X]
        self.config = IMMCTMConfig(
            K=tuple(int(x) for x in k), V=tuple(int(f.shape[0]) for f in self.features),
            D=len(X), dtype=dtype, J=J,
        )
        self.device = check_device(device)
        self.F = tuple(feature_onehots(self.features[m], J[m], dtype, self.device)
                       for m in range(M))
        self.Xdense = counts_tensors(
            [sparse_to_dense([doc[m] for doc in self.X], self.config.V[m]) for m in range(M)],
            self.config, self.device,
        )
        self.state = init(torch.Generator().manual_seed(seed), self.config, full_alpha,
                          device=self.device)
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
    def I(self):
        return list(self.config.I)

    @property
    def J(self):
        return [list(j) for j in self.config.J]

    @property
    def V(self):
        return list(self.config.V)

    @property
    def N(self):
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
        return [[float(v) for v in a[0].cpu()] for a in self.state.alpha]

    def _per_topic(self, nested):
        """[m][i] (1, K_m, J_mi) tensors in the reference's [m][k][i] layout."""
        arrays = [[g[0].cpu().numpy() for g in gm] for gm in nested]
        return [[[arrays[m][i][k] for i in range(self.config.I[m])]
                 for k in range(self.config.K[m])]
                for m in range(self.M)]

    @property
    def gamma(self):
        """γ[m][k][i]: vectors of length J_mi (the reference's nesting)."""
        return self._per_topic(self.state.gamma)

    @property
    def Elnphi(self):
        return self._per_topic(self.state.Elnphi)

    @property
    def phi(self):
        return self._per_topic(phi_point(self.state.gamma))

    @property
    def props(self):
        """props[d][m]: one document's per-topic proportions (reference layout)."""
        p = [x[0].cpu().numpy() for x in props_from_lam(self.state.lam, self.config)]
        return [[p[m][d] for m in range(self.M)] for d in range(self.D)]

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
        terms, from the last E-step."""
        dense = [t[0].cpu().numpy() for t in reconstruct_theta(self.state, self.config)]
        return [[dense[m][d, doc[m][:, 0].astype(np.int64) - 1, :].T for m in range(self.M)]
                for d, doc in enumerate(self.X)]

    # the Julia field names
    μ = mu
    Σ = Sigma
    invΣ = invSigma
    α = alpha
    γ = gamma
    Elnϕ = Elnphi
    ϕ = phi
    λ = lam
    ν = nu
    ζ = zeta
    θ = theta

    def fit(self, maxiter: int = 100, tol: float = 1e-4, verbose: bool = True,
            autoalpha: bool = False, update_sigma: bool = True, **kwargs):
        """`fit!` (src/IMMCTM.jl:437-466), resuming from the current state.
        Returns the per-iteration list of per-modality log-likelihoods.
        `verbose` (the default) prints the resolved inner-solver budgets and
        each iteration's lls. Accepts the Julia spellings autoα and updateΣ."""
        autoalpha, update_sigma = _fit_options(self.config, verbose, autoalpha, update_sigma,
                                               kwargs)
        result = fit(self.state, self.Xdense, self.F, self.config, maxiter=maxiter, tol=tol,
                     verbose=verbose, autoalpha=autoalpha, update_sigma=update_sigma)
        n = _take_result(self, result)
        return [[float(v) for v in row] for row in result.ll_history[0, :n].cpu()]

    fit_ = fit

    def __repr__(self):
        status = (
            f"fitted, ll={[round(v, 5) for v in self.ll]}" if self.ll is not None else "unfitted"
        )
        return f"IMMCTM(K={self.K}, D={self.D}, V={self.V}, {status})"


def transform(model: IMMCTM, X, maxiter: int = 1000, tol: float = 1e-4,
              fit_gaussian: bool = False, verbose: bool = False) -> IMMCTM:
    """IMMCTM fold-in (the JAX package's extension; the reference has no
    IMMCTM transform): a new fitted IMMCTM over X with the model's topics
    frozen, on the model's device and dtype; unless `fit_gaussian` it keeps
    the trained μ, Σ and Σ⁻¹."""
    newmodel = IMMCTM(model.K, model.alpha, model.features, X, dtype=model.config.dtype,
                      device=model.device)
    result = transform_states(model.state, newmodel.state, newmodel.Xdense, newmodel.F,
                              newmodel.config, maxiter=maxiter, tol=tol,
                              fit_gaussian=fit_gaussian, verbose=verbose)
    _take_result(newmodel, result)
    if not fit_gaussian:
        newmodel.state = newmodel.state._replace(
            mu=model.state.mu, Sigma=model.state.Sigma, invSigma=model.state.invSigma
        )
    return newmodel


def fit_heldout(Xheldout, model: IMMCTM, maxiter: int = 100, verbose: bool = False) -> IMMCTM:
    """`fit_heldout(Xheldout, model)` (src/IMMCTM.jl:468-497), on the model's
    device and dtype."""
    heldout = IMMCTM(model.K, model.alpha, model.features, Xheldout, dtype=model.config.dtype,
                     device=model.device)
    _take_result(heldout, fit_heldout_states(model.state, heldout.state, heldout.Xdense,
                                             heldout.F, heldout.config, maxiter=maxiter,
                                             verbose=verbose))
    return heldout


def predict_modality_eta(Xobs, m: int, model: IMMCTM, maxiter: int = 100,
                         verbose: bool = False):
    """`predict_modality_η(Xobs, m, model)` (src/IMMCTM.jl:499-545): 1-based
    `m`, Xobs[doc] the other modalities in their order; the observed fit
    takes their one-hot features. One η array (length K[m]) per document."""
    m0, obsM = _observed(model, m)
    obs_model = IMMCTM([model.K[i] for i in obsM], [model.alpha[i] for i in obsM],
                       [model.features[i] for i in obsM], Xobs, dtype=model.config.dtype,
                       device=model.device)
    eta, _, converged = predict_modality_eta_states(
        model.state, obs_model.state, obs_model.Xdense, m0, obs_model.F, model.config,
        obs_model.config, maxiter=maxiter, verbose=verbose,
    )
    return _eta_list(eta, converged)
