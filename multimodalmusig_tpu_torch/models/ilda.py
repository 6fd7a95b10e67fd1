"""Independent-feature LDA (ILDA) fit by CAVI, in PyTorch.

Counterpart of multimodalmusig_tpu/models/ilda.py (itself a
re-implementation of the reference's src/ILDA.jl): LDA whose vocabulary
factorizes into I independent features through a table features[v, i] ∈
1..J_i, the topic-word distribution a product of per-feature Dirichlets,
p(v|k) = Π_i β_i[features[v,i], k] (src/ILDA.jl:18, 222-229). Each feature
lookup is a one-hot matrix F_i (V, J_i) (`feature_onehots`, which IMMCTM
imports too), so the reference's feature loops become matrix products:
  * the summed log-topic terms Σ_i Elnβ_i[features[v,i], :] = Σ_i F_i Elnβ_i
    (src/ILDA.jl:65-79);
  * the λ scatter-add, λ_i = η_i + F_iᵀ W with W[v,:] = Σ_d X[d,v]·ϕ[d,v,:]
    (src/ILDA.jl:107-126);
  * the likelihood's per-feature product, exp of the summed log gathers
    (src/ILDA.jl:209-236).
The document side is LDA's (models/lda.py): ϕ's two count-weighted
contractions are the θ moments of one θ-moments call each, with the summed
(V, K) log-weights.

Every state tensor carries a leading restart dimension R: λ_i/Elnβ_i tuples
over the features of (R, J_i, K), γ/Elnθ (R, D, K), Elnθ_pre (R, D, K) and
logw_pre (R, V, K).

The JAX package's documented repairs of the reference are kept: `transform`
works (the reference's builds an LDA with a vector η, a method that does not
exist, src/ILDA.jl:293), and ElnQβ accumulates over the features (the
reference overwrites it in its feature loop, src/ILDA.jl:174-181).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.special import dirichlet_expectation, gammaln
from ..utils.formatting import sparse_to_dense
from . import lda
from .ctm_base import check_device, full_f32_matmuls
from .lda import counts_tensor, theta_point, update_gamma

__all__ = [
    "ILDAConfig",
    "ILDAState",
    "ILDAFitResult",
    "ILDA",
    "transform",
    "fit_heldout",
    "feature_onehots",
    "init",
    "summed_Elnbeta",
    "reconstruct_phi",
    "update_gamma",
    "update_phi",
    "unsmoothed_update_phi",
    "update_lambda",
    "beta_point",
    "theta_point",
    "vocab_topic_probs",
    "loglikelihood",
    "calculate_elbo",
    "fit_step_fn",
    "finalize_fit",
    "fit",
    "transform_states",
    "fit_heldout_states",
]


def feature_onehots(features, J: Sequence[int], dtype: torch.dtype = torch.float64,
                    device="cpu") -> Tuple[torch.Tensor, ...]:
    """features (V, I) with 1-based values -> per-feature one-hot (V, J_i)
    tensors of `dtype` on `device`."""
    features = np.asarray(features)
    out = []
    for i, Ji in enumerate(J):
        F = np.zeros((features.shape[0], Ji), dtype=np.float64)
        F[np.arange(features.shape[0]), features[:, i] - 1] = 1.0
        out.append(torch.as_tensor(F).to(device=device, dtype=dtype))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ILDAConfig:
    """Static model configuration (src/ILDA.jl:2-23)."""

    K: int                   # topics
    V: int                   # vocabulary size
    D: int                   # documents
    J: Tuple[int, ...]       # values per feature
    alpha: float             # doc-topic Dirichlet hyperparameter
    eta: Tuple[float, ...]   # per-feature topic Dirichlet hyperparameters
    dtype: torch.dtype = torch.float32

    @property
    def I(self) -> int:
        return len(self.J)

    @property
    def ll_shape(self) -> Tuple[int, ...]:
        """The shape of one lane's ll: a scalar."""
        return ()


class ILDAState(NamedTuple):
    """Variational state, field for field the JAX package's ILDAState with a
    leading restart dimension; the per-feature fields are tuples."""

    lam: Tuple[torch.Tensor, ...]      # per feature (R, J_i, K) topic parameters λ_i
    Elnbeta: Tuple[torch.Tensor, ...]  # per feature (R, J_i, K)
    gamma: torch.Tensor                # (R, D, K)
    Elntheta: torch.Tensor             # (R, D, K)
    Elntheta_pre: torch.Tensor         # (R, D, K) E[ln θ] of the last ϕ-update
    logw_pre: torch.Tensor             # (R, V, K) Σ_i Elnβ_i, or Σ_i ln β_i in inference


ILDAFitResult = lda.LDAFitResult


# ---------------------------------------------------------------------------
# Initialization (src/ILDA.jl:26-57)
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, config: ILDAConfig, restarts: int = 1,
         device="cuda") -> ILDAState:
    """λ_i ~ Uniform{1..100} feature by feature, γ = 1 and zero snapshots
    (the uniform init ϕ, src/ILDA.jl:38-50), for `restarts` lanes on
    `device`: the CUDA card unless the caller asks for the CPU (without a
    card a CUDA device raises). The draws come from `generator` on its own
    device, so a seed gives the same init on every device."""
    device = check_device(device)
    dt, R = config.dtype, restarts
    lam = tuple(
        torch.randint(1, 101, (R, Ji, config.K), generator=generator, device=generator.device)
        .to(device=device, dtype=dt)
        for Ji in config.J
    )
    gamma = torch.ones((R, config.D, config.K), dtype=dt, device=device)
    return ILDAState(
        lam=lam,
        Elnbeta=tuple(dirichlet_expectation(l, axis=-2) for l in lam),
        gamma=gamma,
        Elntheta=dirichlet_expectation(gamma, axis=-1),
        Elntheta_pre=torch.zeros((R, config.D, config.K), dtype=dt, device=device),
        logw_pre=torch.zeros((R, config.V, config.K), dtype=dt, device=device),
    )


# ---------------------------------------------------------------------------
# CAVI updates (src/ILDA.jl:65-130)
# ---------------------------------------------------------------------------


def summed_Elnbeta(Elnbeta: Sequence[torch.Tensor], F: Sequence[torch.Tensor]) -> torch.Tensor:
    """(R, V, K): Σ_i Elnβ_i[features[v,i], :] as one-hot products
    (src/ILDA.jl:65-79)."""
    total = F[0] @ Elnbeta[0]
    for i in range(1, len(F)):
        total = total + F[i] @ Elnbeta[i]
    return total


reconstruct_phi = lda.reconstruct_phi


def update_phi(state: ILDAState, F) -> ILDAState:
    """ϕ[d,v,:] ∝ exp(Elnθ[d,:] + Σ_i Elnβ_i[j_v,:]) (src/ILDA.jl:65-79),
    recorded as the snapshot the next moments read."""
    return lda.phi_update(state, summed_Elnbeta(state.Elnbeta, F))


def unsmoothed_update_phi(state: ILDAState, beta, F) -> ILDAState:
    """Inference-mode ϕ from the point estimates' products
    (src/ILDA.jl:274-290)."""
    return lda.phi_update(state, summed_Elnbeta(tuple(torch.log(b) for b in beta), F))


def update_lambda(state: ILDAState, X: torch.Tensor, F, config: ILDAConfig,
                  phi: torch.Tensor = None) -> ILDAState:
    """λ_i = η_i + F_iᵀ·W, W[v,:] = Σ_d X[d,v]·ϕ[d,v,:], then E[ln β_i]
    (src/ILDA.jl:107-126)."""
    W = lda.word_topic_sums(state, X, phi)
    lam = tuple(config.eta[i] + F[i].mT @ W for i in range(config.I))
    return state._replace(lam=lam, Elnbeta=tuple(dirichlet_expectation(l, axis=-2) for l in lam))


def beta_point(state: ILDAState) -> Tuple[torch.Tensor, ...]:
    """β_i = λ_i normalized over its values (src/ILDA.jl:128-130)."""
    return tuple(l / l.sum(dim=-2, keepdim=True) for l in state.lam)


# ---------------------------------------------------------------------------
# Metrics (src/ILDA.jl:132-236)
# ---------------------------------------------------------------------------


def vocab_topic_probs(beta, F) -> torch.Tensor:
    """(R, V, K): p(v|k) = Π_i β_i[features[v,i], k] (src/ILDA.jl:222-229)."""
    return torch.exp(summed_Elnbeta(tuple(torch.log(b) for b in beta), F))


def loglikelihood(X: torch.Tensor, theta: torch.Tensor, beta, F) -> torch.Tensor:
    """(R,) per-word mixture log-likelihood (src/ILDA.jl:209-236)."""
    return lda.loglikelihood(X, theta, vocab_topic_probs(beta, F))


def calculate_elbo(state: ILDAState, X: torch.Tensor, F, config: ILDAConfig) -> torch.Tensor:
    """Dirichlet-multinomial ELBO with per-feature β terms, (R,)
    (src/ILDA.jl:132-207, ElnQβ accumulated over the features; see the
    module docstring). Forms the last ϕ-update's ϕ as (R, D, V, K)."""
    K = config.K
    ElnPbeta = ElnQbeta = 0.0
    for i in range(config.I):
        eta, Ji, lam, Elnbeta = config.eta[i], config.J[i], state.lam[i], state.Elnbeta[i]
        ElnPbeta = ElnPbeta + K * (math.lgamma(Ji * eta) - Ji * math.lgamma(eta))
        ElnPbeta = ElnPbeta + (eta - 1.0) * Elnbeta.sum(dim=(-2, -1))
        ElnQbeta = ElnQbeta + (gammaln(lam).sum(dim=(-2, -1))
                               - gammaln(lam.sum(dim=-2)).sum(dim=-1)
                               - ((lam - 1.0) * Elnbeta).sum(dim=(-2, -1)))
    return ElnPbeta - ElnQbeta + lda.elbo_document_terms(
        state, X, config, summed_Elnbeta(state.Elnbeta, F), reconstruct_phi(state))


# ---------------------------------------------------------------------------
# Fit loops (src/ILDA.jl:246-353)
# ---------------------------------------------------------------------------


def fit_step_fn(X: torch.Tensor, F, config: ILDAConfig):
    """One CAVI iteration (src/ILDA.jl:246-272): γ → ϕ → λ → ll, two
    θ-moments calls as in LDA."""

    def step(s):
        s = update_lambda(update_phi(update_gamma(s, X, config), F), X, F, config)
        return s, loglikelihood(X, theta_point(s), beta_point(s), F)

    return step


def finalize_fit(carry, X: torch.Tensor, F, config: ILDAConfig) -> ILDAFitResult:
    """A finished CAVI carry as a fit result (final ELBO as at
    src/ILDA.jl:269)."""
    return lda.finalize_fit(carry, X, config, _elbo_with(F))


def _elbo_with(F):
    return lambda state, X, config: calculate_elbo(state, X, F, config)


def fit(state: ILDAState, X: torch.Tensor, F, config: ILDAConfig, maxiter: int = 1000,
        tol: float = 1e-4, compact_schedule=(), progress=None,
        verbose: bool = False) -> ILDAFitResult:
    """Full ILDA CAVI over every lane of `state` (src/ILDA.jl:246-272), with
    TF32 off for all float32 products. X (dense (D, V)) and F (one-hot
    (V, J_i)) are tensors on the state's device and dtype.
    `compact_schedule`, `progress` and `verbose` are ctm_base.run_cavi's."""
    with full_f32_matmuls():
        carry = lda.run_loop(state, config, maxiter, tol, fit_step_fn(X, F, config),
                             compact_schedule, progress, verbose)
        return finalize_fit(carry, X, F, config)


def transform_states(trained: ILDAState, state: ILDAState, Xnew: torch.Tensor, F,
                     config: ILDAConfig, maxiter: int = 1000, tol: float = 1e-4,
                     verbose: bool = False):
    """Fold new documents in with the per-feature point β frozen (the JAX
    package's repair of src/ILDA.jl:288-321): unsmoothed ϕ's from Σ_i ln β_i,
    the trained λ/Elnβ copied in. Returns (θ (R, D, K), the fit result)."""
    with full_f32_matmuls():
        beta = beta_point(trained)
        logw = summed_Elnbeta(tuple(torch.log(b) for b in beta), F)
        state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)
        result = lda.frozen_topics_fit(state, Xnew, config, logw, torch.exp(logw),
                                       _elbo_with(F), maxiter, tol, verbose)
        return theta_point(result.state), result


def fit_heldout_states(trained: ILDAState, state: ILDAState, Xheldout: torch.Tensor, F,
                       config: ILDAConfig, maxiter: int = 100, tol: float = 1e-4,
                       verbose: bool = False) -> ILDAFitResult:
    """Refit the document side of held-out documents with the trained
    λ_i/Elnβ_i copied in (src/ILDA.jl:323-353)."""
    with full_f32_matmuls():
        state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)
        return lda.frozen_topics_fit(state, Xheldout, config, summed_Elnbeta(trained.Elnbeta, F),
                                     vocab_topic_probs(beta_point(trained), F), _elbo_with(F),
                                     maxiter, tol, verbose)


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (src/ILDA.jl:26-63)
# ---------------------------------------------------------------------------


class ILDA:
    """Stateful single-model wrapper: ``ILDA(k, α, η, features, X)`` with η
    a scalar or one value per feature (src/ILDA.jl:26-63), `features` a
    (V, I) table of 1-based feature values (J_i read from its maxima) and X
    a list of (n, 2) 1-based (vocab_index, count) matrices. The state is one
    lane (R = 1) on `device`, the CUDA card unless the caller asks for the
    CPU (without a card a CUDA device raises); its λ comes from a CPU
    generator seeded with `seed`. λ/β/Elnβ come back as lists of (J_i, K)
    numpy arrays, γ/θ/Elnθ as (K, D)."""

    def __init__(self, k, alpha, eta, features, X, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        features = np.asarray(features)
        I = features.shape[1]
        eta = [float(eta)] * I if np.ndim(eta) == 0 else [float(e) for e in eta]
        if len(eta) != I:
            raise ValueError("eta must be a scalar or have one entry per feature")
        J = tuple(int(features[:, i].max()) for i in range(I))
        self.X = [np.asarray(doc) for doc in X]
        self.features = features
        self.config = ILDAConfig(K=int(k), V=int(features.shape[0]), D=len(X), J=J,
                                 alpha=float(alpha), eta=tuple(eta), dtype=dtype)
        self.device = check_device(device)
        self.F = feature_onehots(features, J, dtype, self.device)
        self.Xdense = counts_tensor(sparse_to_dense(self.X, self.config.V), self.config,
                                    self.device)
        self.state = init(torch.Generator().manual_seed(seed), self.config, device=self.device)
        self.converged = False
        self.elbo = None
        self.ll = None

    @property
    def K(self):
        return self.config.K

    @property
    def D(self):
        return self.config.D

    @property
    def I(self):
        return self.config.I

    @property
    def J(self):
        return list(self.config.J)

    @property
    def V(self):
        return self.config.V

    @property
    def alpha(self):
        return self.config.alpha

    @property
    def eta(self):
        return list(self.config.eta)

    @property
    def lam(self) -> List[np.ndarray]:
        return [l[0].cpu().numpy() for l in self.state.lam]

    @property
    def beta(self) -> List[np.ndarray]:
        return [b[0].cpu().numpy() for b in beta_point(self.state)]

    @property
    def Elnbeta(self) -> List[np.ndarray]:
        return [e[0].cpu().numpy() for e in self.state.Elnbeta]

    @property
    def gamma(self):
        return self.state.gamma[0].cpu().numpy().T  # (K, D)

    @property
    def theta(self):
        return theta_point(self.state)[0].cpu().numpy().T

    @property
    def Elntheta(self):
        return self.state.Elntheta[0].cpu().numpy().T

    @property
    def phi(self) -> List[np.ndarray]:
        """Per-document (K, n_d) responsibilities over the present terms."""
        return lda.phi_per_document(self)

    λ = lam
    β = beta
    Elnβ = Elnbeta
    γ = gamma
    θ = theta
    Elnθ = Elntheta
    ϕ = phi
    α = alpha
    η = eta

    def fit(self, maxiter: int = 1000, tol: float = 1e-4, verbose: bool = True):
        """`fit!` (src/ILDA.jl:246-272), resuming from the current state.
        Returns the log-likelihood history; `verbose` prints each
        iteration's ll."""
        result = fit(self.state, self.Xdense, self.F, self.config, maxiter=maxiter, tol=tol,
                     verbose=verbose)
        n = lda.take_result(self, result)
        return [float(v) for v in result.ll_history[0, :n].cpu()]

    fit_ = fit

    def __repr__(self):
        status = f"fitted, ll={self.ll:.5f}" if self.ll is not None else "unfitted"
        return f"ILDA(K={self.K}, D={self.D}, I={self.I}, J={self.J}, {status})"


def transform(model: ILDA, X, maxiter: int = 1000, tol: float = 1e-4, verbose: bool = False):
    """ILDA fold-in on the model's device and dtype; returns θ as a
    (K, D_new) numpy array (repairs the reference's dead code at
    src/ILDA.jl:293, see the module docstring)."""
    X = [np.asarray(doc) for doc in X]
    cfg = dataclasses.replace(model.config, D=len(X))
    fresh = init(torch.Generator().manual_seed(0), cfg, device=model.device)
    theta, result = transform_states(model.state, fresh,
                                     counts_tensor(sparse_to_dense(X, cfg.V), cfg, model.device),
                                     model.F, cfg, maxiter=maxiter, tol=tol, verbose=verbose)
    if not bool(result.converged[0]):
        warnings.warn("transform did not converge")
    return theta[0].cpu().numpy().T


def fit_heldout(Xheldout, model: ILDA, maxiter: int = 100, verbose: bool = False) -> ILDA:
    """`fit_heldout(Xheldout, model)` (src/ILDA.jl:323-353), on the model's
    device and dtype."""
    heldout = ILDA(model.K, model.alpha, model.eta, model.features, Xheldout,
                   dtype=model.config.dtype, device=model.device)
    lda.take_result(heldout, fit_heldout_states(model.state, heldout.state, heldout.Xdense,
                                                heldout.F, heldout.config, maxiter=maxiter,
                                                verbose=verbose))
    return heldout
