"""Multi-Modal Correlated Topic Model (MMCTM) fit by CAVI, in PyTorch.

Counterpart of multimodalmusig_tpu/models/mmctm.py (itself a
re-implementation of the reference's src/MMCTM.jl): a joint logistic-normal
N(μ, Σ) over the concatenated topic space of all modalities with
per-modality Dirichlet topic-word distributions.

Every state tensor carries a leading restart dimension R (a single model is
R = 1): μ (R, MK), Σ/Σ⁻¹ (R, MK, MK), α (R, M), γ/Elnϕ tuples of
(R, K_m, V_m), λ/ν (R, D, MK), ζ (R, D, M). The dense counts X are a tuple
of (D, V_m) tensors shared by all lanes. Nothing here trains by autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.special import dirichlet_expectation, logmvbeta, logmvbeta_symmetric, safe_xlogy, xlogx
from ..utils.formatting import infer_vocab_size, sparse_to_dense
from .ctm_base import (
    CTMBaseConfig,
    carry_converged,
    counts_per_doc,
    elbo_eta_z_term_dict,
    full_f32_matmuls,
    props_from_lam,
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
    "counts_tensors",
    "init",
    "init_with_alpha",
    "e_step_moments",
    "update_mu",
    "update_Sigma",
    "update_gamma",
    "phi_point",
    "props_from",
    "modality_loglikelihoods",
    "elbo_terms",
    "calculate_elbo",
    "fit_step_fn",
    "finalize_fit",
    "fit",
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
         init_method: str = "random", device="cpu") -> MMCTMState:
    """μ=0, Σ=I, λ=0, ν=1 for `restarts` lanes; γ ~ Uniform{1..100}
    (`random`) or seeded with one distinct document's counts per topic
    (`document`), then consistent ζ (src/MMCTM.jl:47-87). The random draws
    come from `generator` on its own device and are moved to `device`, so a
    seed gives the same init on every device."""
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
                    init_method: str = "random", device="cpu") -> MMCTMState:
    """init() plus the user's α vector (src/MMCTM.jl:35), on every lane."""
    state = init(generator, config, X, restarts, init_method, device)
    a = torch.as_tensor(alpha, dtype=config.dtype, device=device)
    return state._replace(alpha=a.expand(restarts, config.M).clone())


# ---------------------------------------------------------------------------
# E-step and M-step (src/MMCTM.jl:110-250)
# ---------------------------------------------------------------------------


def smoothed_logw(state: MMCTMState) -> Tuple[torch.Tensor, ...]:
    """Training log-weights E[ln ϕ] as (R, V_m, K_m) tables (src/MMCTM.jl:183-198)."""
    return tuple(e.mT for e in state.Elnphi)


def reconstruct_theta(state: MMCTMState, config: MMCTMConfig) -> Tuple[torch.Tensor, ...]:
    """The θ of the last E-step, rebuilt from the (λ_pre, logw_pre) snapshot."""
    return theta_from(state.lam_pre, state.logw_pre, config)


def e_step_moments(state: MMCTMState, X, N, config: MMCTMConfig):
    """Batched `fitdoc!` (src/MMCTM.jl:450-455) computing only the θ moments
    the CAVI iteration consumes: sumθ for the λ solve and the γ scatter.
    θ uses the pre-update λ, and both solvers the ζ from the start of the
    E-step, as in the reference. Returns (state, scatters)."""
    logw = smoothed_logw(state)
    sumtheta, scatters = theta_moments(state.lam, logw, X, config)
    zeta, nu, lam = solve_eta(
        state.lam, state.nu, N, sumtheta, state.mu, state.invSigma, config
    )
    return (
        state._replace(zeta=zeta, lam_pre=state.lam, logw_pre=logw, nu=nu, lam=lam),
        scatters,
    )


def update_mu(state: MMCTMState) -> MMCTMState:
    """μ = mean_d λ_d (src/MMCTM.jl:200-202)."""
    return state._replace(mu=update_mu_vec(state.lam))


def update_Sigma(state: MMCTMState, config: MMCTMConfig) -> MMCTMState:
    """Σ = (Σ_d diag(ν_d) + (λ_d-μ)(λ_d-μ)ᵀ) / D, then Σ⁻¹ (src/MMCTM.jl:204-212)."""
    Sigma, invSigma = update_Sigma_mats(state.lam, state.nu, state.mu, config.D)
    return state._replace(Sigma=Sigma, invSigma=invSigma)


def update_gamma(state: MMCTMState, config: MMCTMConfig, scatter) -> MMCTMState:
    """γ_m[k,v] = α_m + Σ_d X_m[d,v]·θ_m[d,v,k] from the E-step's (R, K_m, V_m)
    `scatter`, then E[ln ϕ] (src/MMCTM.jl:224-250, 214-222)."""
    gamma = tuple(state.alpha[:, m, None, None] + scatter[m] for m in range(config.M))
    return state._replace(
        gamma=gamma, Elnphi=tuple(dirichlet_expectation(g, axis=-1) for g in gamma)
    )


props_from = props_from_lam


def phi_point(gamma) -> Tuple[torch.Tensor, ...]:
    """Point estimate ϕ_m[k, :] = γ_m[k, :] / Σ_v γ (src/MMCTM.jl:244-250)."""
    return tuple(g / g.sum(dim=-1, keepdim=True) for g in gamma)


# ---------------------------------------------------------------------------
# ELBO and log-likelihood (src/MMCTM.jl:271-448)
# ---------------------------------------------------------------------------


def elbo_terms(state: MMCTMState, X, N, config: MMCTMConfig) -> dict:
    """The 7 named ELBO terms of src/MMCTM.jl:271-370, each (R,):
    {ElnPphi, ElnPeta, ElnPZ, ElnPX, ElnQphi, ElnQeta, ElnQZ}. Uses the last
    E-step's θ (reconstructed from the carried snapshot)."""
    theta = reconstruct_theta(state, config)
    sumtheta = torch.cat(
        [torch.einsum("dv,rdvk->rdk", X[m], theta[m]) for m in range(config.M)], dim=-1
    )
    terms = elbo_eta_z_term_dict(
        state.lam, state.nu, state.zeta, state.mu, state.invSigma, sumtheta, N, config
    )
    ElnPphi = ElnPX = ElnQphi = ElnQZ = 0.0
    for m in range(config.M):
        a = state.alpha[:, m]
        ElnPphi = ElnPphi - config.K[m] * logmvbeta_symmetric(a, config.V[m])
        ElnPphi = ElnPphi + (a - 1.0) * state.Elnphi[m].sum(dim=(-2, -1))
        ElnPX = ElnPX + torch.einsum("dv,rdvk,rkv->r", X[m], theta[m], state.Elnphi[m])
        ElnQphi = ElnQphi - logmvbeta(state.gamma[m], axis=-1).sum(-1)
        ElnQphi = ElnQphi + ((state.gamma[m] - 1.0) * state.Elnphi[m]).sum(dim=(-2, -1))
        ElnQZ = ElnQZ + torch.einsum("dv,rdvk->r", X[m], xlogx(theta[m]))
    return {
        "ElnPphi": ElnPphi,
        "ElnPeta": terms["ElnPeta"],
        "ElnPZ": terms["ElnPZ"],
        "ElnPX": ElnPX,
        "ElnQphi": ElnQphi,
        "ElnQeta": terms["ElnQeta"],
        "ElnQZ": ElnQZ,
    }


def calculate_elbo(state: MMCTMState, X, N, config: MMCTMConfig) -> torch.Tensor:
    """The 7-term ELBO with the Blei-Lafferty ζ bound (src/MMCTM.jl:271-382), (R,)."""
    t = elbo_terms(state, X, N, config)
    return (
        t["ElnPphi"] + t["ElnPeta"] + t["ElnPZ"] + t["ElnPX"]
        - t["ElnQphi"] - t["ElnQeta"] - t["ElnQZ"]
    )


def modality_loglikelihoods(X, props, phi) -> torch.Tensor:
    """(R, M) per-modality per-word mixture log-likelihood:
    Σ_d Σ_v X·log(Σ_k props·ϕ) / Σ_d N_d (src/MMCTM.jl:384-448)."""
    return torch.stack(
        [safe_xlogy(X[m], props[m] @ phi[m]).sum(dim=(-2, -1)) / X[m].sum()
         for m in range(len(X))],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Fit (src/MMCTM.jl:457-494)
# ---------------------------------------------------------------------------


def fit_step_fn(X, N, config: MMCTMConfig):
    """One CAVI iteration as a closure (src/MMCTM.jl:463-479): batched E-step
    (ζ/θ/ν/λ ∀d) → μ → Σ → γ → per-modality log-likelihoods."""

    def step(s):
        s, scatters = e_step_moments(s, X, N, config)
        s = update_gamma(update_Sigma(update_mu(s), config), config, scatters)
        return s, modality_loglikelihoods(X, props_from(s.lam, config), phi_point(s.gamma))

    return step


def finalize_fit(carry, X, N, config: MMCTMConfig) -> MMCTMFitResult:
    """A finished CAVI carry as an MMCTMFitResult (final ELBO as at
    src/MMCTM.jl:490)."""
    state, ll_buf, n_iters, done = carry
    lanes = torch.arange(ll_buf.shape[0], device=ll_buf.device)
    return MMCTMFitResult(
        state=state,
        ll_history=ll_buf,
        n_iters=n_iters,
        converged=carry_converged(ll_buf, n_iters, done),
        elbo=calculate_elbo(state, X, N, config),
        ll=ll_buf[lanes, n_iters - 1],
    )


def fit(state: MMCTMState, X, config: MMCTMConfig, maxiter: int = 100,
        tol: float = 1e-4) -> MMCTMFitResult:
    """Full MMCTM CAVI over every lane of `state` (src/MMCTM.jl:457-494),
    with TF32 off for all float32 products. X is a tuple of dense (D, V_m)
    tensors on the state's device and dtype."""
    X = tuple(X)
    with full_f32_matmuls():
        N = counts_per_doc(X)
        carry = run_cavi(state, config, maxiter, tol, fit_step_fn(X, N, config))
        return finalize_fit(carry, X, N, config)


# ---------------------------------------------------------------------------
# Stateful wrapper mirroring the Julia API (src/MMCTM.jl:29-108)
# ---------------------------------------------------------------------------


class MMCTM:
    """Stateful single-model wrapper with the reference's constructor/field
    surface: ``MMCTM(k, α, X)`` or ``MMCTM(k, α, V, X)`` where X[doc][modality]
    is an (n, 2) 1-based (vocab_index, count) matrix. The state is one lane
    (R = 1) on `device`; its γ comes from a CPU generator seeded with `seed`."""

    def __init__(self, k, alpha, *args, init: str = "random", seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cpu"):
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
        self.device = torch.device(device)
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
    def lam(self):
        return list(self.state.lam[0].cpu().numpy())

    @property
    def nu(self):
        return list(self.state.nu[0].cpu().numpy())

    @property
    def zeta(self):
        return list(self.state.zeta[0].cpu().numpy())

    def fit(self, maxiter: int = 100, tol: float = 1e-4):
        """`fit!` (src/MMCTM.jl:457-494), resuming from the current state.
        Returns the per-iteration list of per-modality log-likelihoods."""
        result = fit(self.state, self.Xdense, self.config, maxiter=maxiter, tol=tol)
        self.state = result.state
        n = int(result.n_iters[0])
        self.converged = bool(result.converged[0])
        self.elbo = float(result.elbo[0])
        self.ll = [float(v) for v in result.ll[0].cpu()]
        return [[float(v) for v in row] for row in result.ll_history[0, :n].cpu()]

    def __repr__(self):
        status = (
            f"fitted, ll={[round(v, 5) for v in self.ll]}" if self.ll is not None else "unfitted"
        )
        return f"MMCTM(K={self.K}, D={self.D}, V={self.V}, {status})"
