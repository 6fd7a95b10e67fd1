"""Smoothed LDA fit by coordinate-ascent variational inference, in PyTorch.

Counterpart of multimodalmusig_tpu/models/lda.py (itself a
re-implementation of the reference's src/LDA.jl). Every state tensor
carries a leading restart dimension R (a single model is R = 1): λ/Elnβ
(R, V, K), γ/Elnθ (R, D, K), and the snapshot of the last ϕ-update,
Elnθ_pre (R, D, K) and logw_pre (R, V, K). The dense counts X (D, V) are
shared by every lane.

The responsibilities ϕ[r,d,v,:] = softmax(Elnθ_pre[r,d,:] + logw_pre[r,v,:])
are never stored, and outside the ELBO never formed: γ − α and (λ − η)ᵀ are
ϕ's two count-weighted contractions, Σ_v X·ϕ and Σ_d X·ϕ, which are the θ
moments of the CTM families (`ctm_base.theta_moments_one`, the θ-moments
kernel on the card) with E[ln θ] in λ's place and the topic log-weights in
E[ln ϕ]'s. A fit iteration takes two such calls, γ's from the previous
snapshot and λ's from the new one; the inference loops take one.

models/ilda.py shares the document side (`update_gamma`, `theta_point`,
the inference loop, the ELBO's document terms) with this module.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.special import dirichlet_expectation, gammaln, safe_xlogy, xlogx
from ..utils.formatting import infer_vocab_size, sparse_to_dense
from .ctm_base import (_fit_result, _take_result, check_device, full_f32_matmuls, run_cavi,
                       theta_moments_one)

__all__ = [
    "LDAConfig",
    "LDAState",
    "LDAFitResult",
    "LDA",
    "transform",
    "fit_heldout",
    "counts_tensor",
    "init",
    "phi_from",
    "reconstruct_phi",
    "update_gamma",
    "phi_update",
    "update_phi",
    "unsmoothed_update_phi",
    "word_topic_sums",
    "update_lambda",
    "beta_point",
    "theta_point",
    "loglikelihood",
    "elbo_document_terms",
    "calculate_elbo",
    "run_loop",
    "fit_step_fn",
    "finalize_fit",
    "fit",
    "frozen_topics_fit",
    "take_result",
    "phi_per_document",
    "transform_states",
    "fit_heldout_states",
]


@dataclasses.dataclass(frozen=True)
class LDAConfig:
    """Static model configuration (src/LDA.jl:2-16)."""

    K: int              # topics
    V: int              # vocabulary size
    D: int              # documents
    alpha: float        # doc-topic Dirichlet hyperparameter α
    eta: float          # topic-word Dirichlet hyperparameter η
    dtype: torch.dtype = torch.float32

    @property
    def ll_shape(self) -> Tuple[int, ...]:
        """The shape of one lane's ll: a scalar."""
        return ()


class LDAState(NamedTuple):
    """Variational state, field for field the JAX package's LDAState with a
    leading restart dimension."""

    lam: torch.Tensor           # (R, V, K) topic-word Dirichlet parameters λ
    Elnbeta: torch.Tensor       # (R, V, K) E[ln β]
    gamma: torch.Tensor         # (R, D, K) doc-topic Dirichlet parameters γ
    Elntheta: torch.Tensor      # (R, D, K) E[ln θ]
    Elntheta_pre: torch.Tensor  # (R, D, K) E[ln θ] of the last ϕ-update
    logw_pre: torch.Tensor      # (R, V, K) its log-weights: E[ln β], or ln β in inference


class LDAFitResult(NamedTuple):
    state: LDAState
    ll_history: torch.Tensor  # (R, maxiter), 0 past n_iters
    n_iters: torch.Tensor     # (R,)
    converged: torch.Tensor   # (R,)
    elbo: torch.Tensor        # (R,) final ELBO (src/LDA.jl:221)
    ll: torch.Tensor          # (R,) final per-word log-likelihood


def counts_tensor(X, config, device) -> torch.Tensor:
    """Dense (D, V) counts (a numpy array or a tensor) as a tensor of the
    config's dtype on `device`."""
    return torch.as_tensor(X).to(device=device, dtype=config.dtype)


# ---------------------------------------------------------------------------
# Initialization (src/LDA.jl:24-55)
# ---------------------------------------------------------------------------


def init(generator: torch.Generator, config: LDAConfig, restarts: int = 1,
         device="cuda") -> LDAState:
    """λ ~ Uniform{1..100} (src/LDA.jl:36), γ = 1 (src/LDA.jl:41) and zero
    snapshots, whose ϕ is the reference's uniform 1/K init
    (src/LDA.jl:47-50), for `restarts` lanes on `device`: the CUDA card
    unless the caller asks for the CPU (without a card a CUDA device
    raises). The draws come from `generator` on its own device and are
    moved to `device`, so a seed gives the same init on every device."""
    device = check_device(device)
    dt, R = config.dtype, restarts
    lam = torch.randint(1, 101, (R, config.V, config.K), generator=generator,
                        device=generator.device).to(device=device, dtype=dt)
    gamma = torch.ones((R, config.D, config.K), dtype=dt, device=device)
    return LDAState(
        lam=lam,
        Elnbeta=dirichlet_expectation(lam, axis=-2),
        gamma=gamma,
        Elntheta=dirichlet_expectation(gamma, axis=-1),
        Elntheta_pre=torch.zeros((R, config.D, config.K), dtype=dt, device=device),
        logw_pre=torch.zeros((R, config.V, config.K), dtype=dt, device=device),
    )


# ---------------------------------------------------------------------------
# CAVI updates (src/LDA.jl:69-112)
# ---------------------------------------------------------------------------


def phi_from(Elntheta: torch.Tensor, logw: torch.Tensor) -> torch.Tensor:
    """(R, D, V, K) responsibilities: softmax over topics of
    Elnθ[r,d,:] + logw[r,v,:]. Materializes ϕ: the ELBO and the wrapper's
    `phi` only."""
    return torch.softmax(Elntheta[:, :, None, :] + logw[:, None, :, :], dim=-1)


def reconstruct_phi(state) -> torch.Tensor:
    """The ϕ of the last ϕ-update, from the carried snapshot (exact)."""
    return phi_from(state.Elntheta_pre, state.logw_pre)


def phi_update(state, logw):
    """A ϕ-update with the log-weights `logw` (R, V, K): records (E[ln θ],
    logw), the tables the next moments form ϕ from."""
    return state._replace(Elntheta_pre=state.Elntheta, logw_pre=logw)


def update_gamma(state, X: torch.Tensor, config, phi: torch.Tensor = None):
    """γ[d,:] = α + Σ_v X[d,v]·ϕ[d,v,:], then E[ln θ] (src/LDA.jl:82-90).
    ϕ defaults to the last ϕ-update's, whose count-weighted sum over v is
    the sumθ of one θ-moments call without its scatter; a given (R, D, V,
    K) `phi` is contracted as it is."""
    if phi is None:
        sumtheta, _ = theta_moments_one(state.Elntheta_pre, state.logw_pre, X,
                                        want_scatter=False)
    else:
        sumtheta = torch.einsum("dv,rdvk->rdk", X, phi)
    gamma = config.alpha + sumtheta
    return state._replace(gamma=gamma, Elntheta=dirichlet_expectation(gamma, axis=-1))


def update_phi(state):
    """ϕ[d,v,:] ∝ exp(Elnθ[d,:] + Elnβ[v,:]) (src/LDA.jl:69-76), recorded
    as the snapshot the next moments read."""
    return phi_update(state, state.Elnbeta)


def unsmoothed_update_phi(state, beta: torch.Tensor):
    """Inference-mode ϕ from the point estimate β (src/LDA.jl:226-231)."""
    return phi_update(state, torch.log(beta))


def word_topic_sums(state, X: torch.Tensor, phi: torch.Tensor = None) -> torch.Tensor:
    """(R, V, K): Σ_d X[d,v]·ϕ[d,v,:], from the last ϕ-update (the scatter
    of one θ-moments call, transposed) or from a given `phi`."""
    if phi is not None:
        return torch.einsum("dv,rdvk->rvk", X, phi)
    _, scatter = theta_moments_one(state.Elntheta_pre, state.logw_pre, X)
    return scatter.mT.contiguous()


def update_lambda(state, X: torch.Tensor, config, phi: torch.Tensor = None):
    """λ[v,:] = η + Σ_d ϕ[d,v,:]·X[d,v], then E[ln β] (src/LDA.jl:100-108)."""
    lam = config.eta + word_topic_sums(state, X, phi)
    return state._replace(lam=lam, Elnbeta=dirichlet_expectation(lam, axis=-2))


def beta_point(state) -> torch.Tensor:
    """β = λ normalized over the vocabulary (src/LDA.jl:110-112), (R, V, K)."""
    return state.lam / state.lam.sum(dim=-2, keepdim=True)


def theta_point(state) -> torch.Tensor:
    """θ = γ normalized over the topics (src/LDA.jl:92-94), (R, D, K)."""
    return state.gamma / state.gamma.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Metrics (src/LDA.jl:114-196)
# ---------------------------------------------------------------------------


def loglikelihood(X: torch.Tensor, theta: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """(R,) per-word mixture log-likelihood Σ X·log(θ·βᵀ) / ΣX
    (src/LDA.jl:174-190), one batched matmul."""
    return safe_xlogy(X, theta @ beta.mT).sum(dim=(-2, -1)) / X.sum()


def elbo_document_terms(state, X: torch.Tensor, config, logw: torch.Tensor,
                        phi: torch.Tensor) -> torch.Tensor:
    """The ELBO's terms that LDA and ILDA share, (R,): ElnPθ + ElnPZ +
    ElnPX − ElnQθ − ElnQZ, with ϕ `phi` and the topics' E[ln p(v|k)]
    `logw` (R, V, K). ElnQZ sums ϕ·ln ϕ over the present terms, masked, not
    weighted by counts, as the reference does (src/LDA.jl:160-166)."""
    K, D, alpha = config.K, config.D, config.alpha
    present = (X > 0).to(phi.dtype)
    ElnPtheta = (D * (math.lgamma(K * alpha) - K * math.lgamma(alpha))
                 + (alpha - 1.0) * state.Elntheta.sum(dim=(-2, -1)))
    ElnPZ = torch.einsum("rdvk,rdk,dv->r", phi, state.Elntheta, X)
    ElnPX = torch.einsum("rdvk,rvk,dv->r", phi, logw, X)
    ElnQtheta = (gammaln(state.gamma).sum(dim=(-2, -1))
                 - gammaln(state.gamma.sum(dim=-1)).sum(dim=-1)
                 - ((state.gamma - 1.0) * state.Elntheta).sum(dim=(-2, -1)))
    ElnQZ = torch.einsum("rdvk,dv->r", xlogx(phi), present)
    return ElnPtheta + ElnPZ + ElnPX - ElnQtheta - ElnQZ


def calculate_elbo(state: LDAState, X: torch.Tensor, config: LDAConfig,
                   phi: torch.Tensor = None) -> torch.Tensor:
    """Dirichlet-multinomial ELBO, the 7 terms of src/LDA.jl:114-172, (R,).
    ϕ defaults to the last ϕ-update's (reconstructed), the state the
    reference computes the final ELBO from (src/LDA.jl:221). Forms ϕ as
    (R, D, V, K)."""
    if phi is None:
        phi = reconstruct_phi(state)
    K, V, eta = config.K, config.V, config.eta
    ElnPbeta = (K * (math.lgamma(V * eta) - V * math.lgamma(eta))
                + (eta - 1.0) * state.Elnbeta.sum(dim=(-2, -1)))
    ElnQbeta = (gammaln(state.lam).sum(dim=(-2, -1))
                - gammaln(state.lam.sum(dim=-2)).sum(dim=-1)
                - ((state.lam - 1.0) * state.Elnbeta).sum(dim=(-2, -1)))
    return ElnPbeta - ElnQbeta + elbo_document_terms(state, X, config, state.Elnbeta, phi)


# ---------------------------------------------------------------------------
# Fit loops (src/LDA.jl:198-295)
# ---------------------------------------------------------------------------


def run_loop(state, config, maxiter: int, tol: float, step_fn, compact_schedule=(),
             progress=None, verbose: bool = False):
    """ctm_base.run_cavi with one ll per lane and the JAX LDA/ILDA loops'
    verbose line, "<iteration>\\tLog-likelihood: <ll>"."""
    return run_cavi(state, config, maxiter, tol, step_fn, compact_schedule, progress, verbose,
                    verbose_label="Log-likelihood")


def fit_step_fn(X: torch.Tensor, config: LDAConfig):
    """One CAVI iteration in the reference's order (src/LDA.jl:201-209):
    γ from the previous ϕ, ϕ ← (Elnθ, Elnβ), λ from that new ϕ, the ll. The
    two ϕ's differ, so the iteration takes two θ-moments calls."""

    def step(s):
        s = update_lambda(update_phi(update_gamma(s, X, config)), X, config)
        return s, loglikelihood(X, theta_point(s), beta_point(s))

    return step


def finalize_fit(carry, X: torch.Tensor, config: LDAConfig, elbo=calculate_elbo) -> LDAFitResult:
    """A finished CAVI carry as an LDAFitResult, its ELBO `elbo(state, X,
    config)` (src/LDA.jl:221)."""
    return _fit_result(LDAFitResult, carry, elbo(carry[0], X, config))


def fit(state: LDAState, X: torch.Tensor, config: LDAConfig, maxiter: int = 1000,
        tol: float = 1e-4, compact_schedule=(), progress=None,
        verbose: bool = False) -> LDAFitResult:
    """Full smoothed-LDA CAVI over every lane of `state` (src/LDA.jl:198-224),
    with TF32 off for all float32 products. X is the dense (D, V) counts on
    the state's device and dtype. `compact_schedule` (any iterable of
    budgets), `progress(done, total)` and `verbose` are ctm_base.run_cavi's."""
    with full_f32_matmuls():
        carry = run_loop(state, config, maxiter, tol, fit_step_fn(X, config), compact_schedule,
                         progress, verbose)
        return finalize_fit(carry, X, config)


def frozen_topics_fit(state, X: torch.Tensor, config, logw: torch.Tensor,
                      word_probs: torch.Tensor, elbo, maxiter: int, tol: float,
                      verbose: bool):
    """The inference loop of LDA and ILDA, the topics frozen: each iteration
    γ from the last ϕ (one θ-moments call, sumθ only), then ϕ ← (Elnθ,
    `logw`), then the ll under θ and the frozen p(v|k) `word_probs`
    (R, V, K). Returns the fit result, its ELBO `elbo(state, X, config)`."""
    def step(s):
        s = phi_update(update_gamma(s, X, config), logw)
        return s, loglikelihood(X, theta_point(s), word_probs)

    carry = run_loop(state, config, maxiter, tol, step, verbose=verbose)
    return finalize_fit(carry, X, config, elbo)


def transform_states(trained: LDAState, state: LDAState, Xnew: torch.Tensor, config: LDAConfig,
                     maxiter: int = 1000, tol: float = 1e-4, verbose: bool = False):
    """Fold new documents into the trained point estimate β, every lane of
    `state` against the same lane of `trained` (src/LDA.jl:233-263), with
    unsmoothed ϕ's (log-weights ln β). As in the JAX package, the trained
    λ/Elnβ are copied in, so the returned ELBO is that of {trained topics,
    new-document γ, inference ϕ}. Returns (θ (R, D, K), the fit result)."""
    with full_f32_matmuls():
        beta = beta_point(trained)
        state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)
        result = frozen_topics_fit(state, Xnew, config, torch.log(beta), beta, calculate_elbo,
                                   maxiter, tol, verbose)
        return theta_point(result.state), result


def fit_heldout_states(trained: LDAState, state: LDAState, Xheldout: torch.Tensor,
                       config: LDAConfig, maxiter: int = 100, tol: float = 1e-4,
                       verbose: bool = False) -> LDAFitResult:
    """Refit the document side of held-out documents with the trained λ and
    E[ln β] copied in (src/LDA.jl:265-295): ϕ from E[ln β], the ll under
    the trained β."""
    with full_f32_matmuls():
        state = state._replace(lam=trained.lam, Elnbeta=trained.Elnbeta)
        return frozen_topics_fit(state, Xheldout, config, trained.Elnbeta, beta_point(trained),
                                 calculate_elbo, maxiter, tol, verbose)


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (constructors at src/LDA.jl:24-67)
# ---------------------------------------------------------------------------


# lane 0 of a fit result into an LDA or ILDA wrapper (ctm_base._take_result)
take_result = _take_result


def phi_per_document(model) -> List[np.ndarray]:
    """Lane 0's ϕ as one (K, n_d) matrix per document over its present
    terms, in the sparse row order of X (the reference's layout,
    src/LDA.jl:14)."""
    dense = reconstruct_phi(model.state)[0].cpu().numpy()
    return [dense[d, doc[:, 0].astype(np.int64) - 1, :].T for d, doc in enumerate(model.X)]


class LDA:
    """Stateful single-model wrapper with the reference's constructor and
    field surface: ``LDA(k, α, η, X)`` or ``LDA(k, α, η, V, X)`` where X is
    a list of (n, 2) 1-based (vocab_index, count) matrices
    (src/LDA.jl:24-67). The state is one lane (R = 1) on `device`, the CUDA
    card unless the caller asks for the CPU (without a card a CUDA device
    raises); its λ comes from a CPU generator seeded with `seed`. The array
    fields come back as numpy arrays in the reference's orientation: λ/β/Elnβ
    (V, K), γ/θ/Elnθ (K, D); the Julia spellings (`model.λ`, ...) alias
    them."""

    def __init__(self, k, alpha, eta, *args, seed: int = 0, dtype: torch.dtype = torch.float32,
                 device="cuda"):
        if len(args) == 2:
            V, X = args
        elif len(args) == 1:
            X = args[0]
            V = infer_vocab_size(X)
        else:
            raise TypeError("LDA(k, alpha, eta, [V,] X)")
        self.X = [np.asarray(doc) for doc in X]
        self.config = LDAConfig(K=int(k), V=int(V), D=len(X), alpha=float(alpha),
                                eta=float(eta), dtype=dtype)
        self.device = check_device(device)
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
    def V(self):
        return self.config.V

    @property
    def N(self) -> List[int]:
        return [int(doc[:, 1].sum()) if len(doc) else 0 for doc in self.X]

    @property
    def alpha(self):
        return self.config.alpha

    @property
    def eta(self):
        return self.config.eta

    @property
    def lam(self):
        return self.state.lam[0].cpu().numpy()

    @property
    def beta(self):
        return beta_point(self.state)[0].cpu().numpy()

    @property
    def Elnbeta(self):
        return self.state.Elnbeta[0].cpu().numpy()

    @property
    def gamma(self):
        return self.state.gamma[0].cpu().numpy().T  # (K, D) as in src/LDA.jl:12

    @property
    def theta(self):
        return theta_point(self.state)[0].cpu().numpy().T

    @property
    def Elntheta(self):
        return self.state.Elntheta[0].cpu().numpy().T

    @property
    def phi(self) -> List[np.ndarray]:
        """Per-document (K, n_d) responsibilities over the present terms."""
        return phi_per_document(self)

    # the Julia field names
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
        """`fit!` (src/LDA.jl:198-224), resuming from the current state.
        Returns the log-likelihood history. `verbose` (the default, as in
        the reference) prints each iteration's ll."""
        result = fit(self.state, self.Xdense, self.config, maxiter=maxiter, tol=tol,
                     verbose=verbose)
        n = take_result(self, result)
        return [float(v) for v in result.ll_history[0, :n].cpu()]

    fit_ = fit

    def __repr__(self):
        status = f"fitted, ll={self.ll:.5f}" if self.ll is not None else "unfitted"
        return f"LDA(K={self.K}, D={self.D}, V={self.V}, {status})"


def transform(model: LDA, X, maxiter: int = 1000, tol: float = 1e-4, verbose: bool = False):
    """`transform(model, X)` (src/LDA.jl:233-263): fold new documents into
    the trained β on the model's device and dtype; returns θ as a (K, D_new)
    numpy array. As in the JAX package, not converging warns (the
    reference's pre-1.0 `warn` call would raise)."""
    X = [np.asarray(doc) for doc in X]
    cfg = dataclasses.replace(model.config, D=len(X))
    fresh = init(torch.Generator().manual_seed(0), cfg, device=model.device)
    theta, result = transform_states(model.state, fresh,
                                     counts_tensor(sparse_to_dense(X, cfg.V), cfg, model.device),
                                     cfg, maxiter=maxiter, tol=tol, verbose=verbose)
    if not bool(result.converged[0]):
        warnings.warn("transform did not converge")
    return theta[0].cpu().numpy().T


def fit_heldout(Xheldout, model: LDA, maxiter: int = 100, verbose: bool = False) -> LDA:
    """`fit_heldout(Xheldout, model)` (src/LDA.jl:265-295): a new LDA over
    the held-out documents with the model's topics, its ll the held-out
    per-word log-likelihood; on the model's device and dtype."""
    heldout = LDA(model.K, model.alpha, model.eta, model.V, Xheldout, dtype=model.config.dtype,
                  device=model.device)
    take_result(heldout, fit_heldout_states(model.state, heldout.state, heldout.Xdense,
                                            heldout.config, maxiter=maxiter, verbose=verbose))
    return heldout
