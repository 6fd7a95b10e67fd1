"""Logistic-normal CTM machinery for the MMCTM fit, in PyTorch.

Counterpart of multimodalmusig_tpu/models/ctm_base.py. Restarts are a
written-out leading dimension R instead of a `vmap`: λ/ν are (R, D, MK),
ζ (R, D, M), μ (R, MK), Σ/Σ⁻¹ (R, MK, MK); the counts X (a tuple of
(D, V_m)) and N (D, M) are shared by every lane.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..ops import lambda_kernel
from ..ops.convergence import MIN_ITERS_BEFORE_CONVERGENCE, relative_change
from ..ops.solvers import (
    CG_F32_CAVI,
    LAMBDA_NITER_F32_CAVI,
    LAMBDA_POLISH_F32_CAVI,
    NU_FP_F32_CAVI,
    maximize_lambda,
    maximize_nu,
)

__all__ = [
    "CTMBaseConfig",
    "full_f32_matmuls",
    "counts_per_doc",
    "calculate_Ndivzeta",
    "theta_moments",
    "theta_from",
    "update_zeta",
    "resolved_budgets",
    "solve_lambda",
    "solve_eta",
    "update_mu_vec",
    "update_Sigma_mats",
    "spd_inverse",
    "props_from_lam",
    "run_cavi",
    "carry_converged",
    "elbo_eta_z_term_dict",
    "DONE_CHECK_EVERY",
]

# The CAVI host loop reads `done.all()` (a device→host sync) once per this
# many iterations. Finished lanes are frozen, so the value changes only how
# many wasted iterations may follow the last lane's convergence, never the
# results.
DONE_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class CTMBaseConfig:
    """Static per-modality topic/vocab structure. The inner-solver budgets
    default (None) to the dtype-dependent values of `resolved_budgets`."""

    K: Tuple[int, ...]  # topics per modality
    V: Tuple[int, ...]  # vocab items per modality
    D: int              # documents
    dtype: torch.dtype = torch.float32
    lambda_n_iter: Optional[int] = None
    lambda_cg_iter: Optional[int] = None
    lambda_polish_iter: Optional[int] = None
    nu_n_iter: Optional[int] = None

    @property
    def M(self) -> int:
        return len(self.K)

    @property
    def MK(self) -> int:
        return sum(self.K)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for k in self.K:
            out.append(acc)
            acc += k
        return tuple(out)

    def block(self, arr: torch.Tensor, m: int) -> torch.Tensor:
        """Slice modality m's topic block from the last axis."""
        o = self.offsets[m]
        return arr[..., o : o + self.K[m]]


@contextlib.contextmanager
def full_f32_matmuls():
    """Run the block with TF32 off for every float32 product (cuBLAS and
    cuDNN) and float32 matmul precision "highest", restoring the caller's
    settings after. Σ⁻¹ is ill-conditioned on real data (cond ≳ 1e4 on
    BRCA) and the factorized θ moments put any matmul error on the softmax
    normalizer, so TF32's ~1e-3 relative error is not acceptable here —
    the same reason the JAX package pins Precision.HIGHEST."""
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def counts_per_doc(X) -> torch.Tensor:
    """N[d, m] = total counts of document d in modality m (src/MMCTM.jl:37)."""
    return torch.stack([Xm.sum(dim=1) for Xm in X], dim=1)


def calculate_Ndivzeta(N: torch.Tensor, zeta: torch.Tensor, config) -> torch.Tensor:
    """(R, D, MK): N_dm/ζ_dm broadcast to modality m's topic block
    (src/MMCTM.jl:119-125)."""
    ratio = N / zeta
    return torch.cat(
        [ratio[..., m : m + 1].expand(*ratio.shape[:-1], config.K[m]) for m in range(config.M)],
        dim=-1,
    )


def theta_moments(lam, logw, X, config):
    """Both count-weighted θ moments without materializing θ: (sumθ
    (R, D, MK), scatters tuple of (R, K_m, V_m)).

    θ[d,v,k] = softmax_k(λ_dk + w_vk) factors exactly: with A = exp(λ_block
    − max_k λ_block) and B = exp(w − max_k w), Z = A Bᵀ (D, V), R = X / Z,
    sumθ = A ⊙ (R B) and scatter = (B ⊙ (Rᵀ A))ᵀ — three batched matmuls per
    modality (ctm_base.py:132-202 of the JAX package documents the math and
    its f32 underflow gap, which fails safe: the lane's ll goes non-finite
    and the lane stops)."""
    sum_parts, scatters = [], []
    for m in range(config.M):
        lam_m = config.block(lam, m)
        A = torch.exp(lam_m - lam_m.amax(dim=-1, keepdim=True))            # (R, D, K)
        B = torch.exp(logw[m] - logw[m].amax(dim=-1, keepdim=True))        # (R, V, K)
        Rm = X[m] / (A @ B.mT)                                             # (R, D, V)
        sum_parts.append(A * (Rm @ B))
        scatters.append((B * (Rm.mT @ A)).mT)
    return torch.cat(sum_parts, dim=-1), tuple(scatters)


def theta_from(lam, logw, config) -> Tuple[torch.Tensor, ...]:
    """θ[r,d,v,:] = softmax(λ_block[r,d,:] + logw_m[r,v,:]) as (R, D, V_m, K_m)
    tensors (src/MMCTM.jl:183-198). Materializes θ: the ELBO only."""
    return tuple(
        torch.softmax(config.block(lam, m)[:, :, None, :] + logw[m][:, None, :, :], dim=-1)
        for m in range(config.M)
    )


def update_zeta(lam: torch.Tensor, nu: torch.Tensor, config) -> torch.Tensor:
    """ζ_dm = Σ_k exp(λ+ν/2) over modality m's block (src/MMCTM.jl:172-181)."""
    e = torch.exp(lam + 0.5 * nu)
    return torch.stack([config.block(e, m).sum(dim=-1) for m in range(config.M)], dim=-1)


def resolved_budgets(config) -> dict:
    """The inner-solver budgets a fit with this config runs:
    {"lambda_n_iter", "lambda_cg_iter", "lambda_polish_iter", "nu_n_iter"},
    None meaning the solver's own cold-start default. Float32 fits take the
    warm-start caps measured in the JAX package (Newton 3, PCG 4, polish 1,
    ν sweeps 4); float64 keeps the full budgets. Config fields always win."""
    f32 = config.dtype == torch.float32
    out = {
        "lambda_n_iter": LAMBDA_NITER_F32_CAVI if f32 else None,
        "lambda_cg_iter": CG_F32_CAVI if f32 else None,
        "lambda_polish_iter": LAMBDA_POLISH_F32_CAVI if f32 else None,
        "nu_n_iter": NU_FP_F32_CAVI if f32 else None,
    }
    for name in out:
        if getattr(config, name) is not None:
            out[name] = int(getattr(config, name))
    return out


def solve_lambda(lam, nu, Ndivzeta, sumtheta, mu, invSigma,
                 n_iter=None, cg_iter=None, polish_iter=None):
    """Batched λ maximization (replaces NLopt at src/MMCTM.jl:127-143) over
    (R, D, MK) with per-lane μ (R, MK) and Σ⁻¹ (R, MK, MK).

    Dispatch is an explicit rule, not an error path: a CUDA float32 tensor
    goes to the fused CUDA kernel (ops/lambda_kernel.py, f32 like the TPU
    kernel it replaces); a CPU tensor, or a CUDA float64 one, goes to the
    plain solver (ops/solvers.maximize_lambda)."""
    kw = {"n_iter": n_iter, "cg_iter": cg_iter, "polish_iter": polish_iter}
    kw = {k: int(v) for k, v in kw.items() if v is not None}
    if lam.is_cuda and lam.dtype == torch.float32:
        return lambda_kernel.maximize_lambda_restarts(
            lam, nu, Ndivzeta, sumtheta, mu, invSigma, **kw
        )
    return maximize_lambda(lam, nu, Ndivzeta, sumtheta, mu, invSigma, **kw)


def solve_eta(lam, nu, N, sumtheta, mu, invSigma, config):
    """The η side of one batched `fitdoc!` (src/MMCTM.jl:450-455, minus θ):
    ζ (closed form) → N/ζ → ν solve → λ solve, for every lane and document.
    Returns (ζ, ν', λ')."""
    budgets = resolved_budgets(config)
    zeta = update_zeta(lam, nu, config)
    Ndivzeta = calculate_Ndivzeta(N, zeta, config)
    diag = torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2)
    nu_kw = {} if budgets["nu_n_iter"] is None else {"n_iter": budgets["nu_n_iter"]}
    nu2 = maximize_nu(nu, lam, Ndivzeta, diag, **nu_kw)
    lam2 = solve_lambda(
        lam, nu2, Ndivzeta, sumtheta, mu, invSigma,
        n_iter=budgets["lambda_n_iter"], cg_iter=budgets["lambda_cg_iter"],
        polish_iter=budgets["lambda_polish_iter"],
    )
    return zeta, nu2, lam2


def update_mu_vec(lam: torch.Tensor) -> torch.Tensor:
    """μ = mean_d λ_d (src/MMCTM.jl:200-202): (R, D, MK) -> (R, MK)."""
    return lam.mean(dim=-2)


def spd_inverse(Sigma: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky inverse of SPD matrices (vs. LU `inv` at
    src/MMCTM.jl:211), with no device→host sync: `cholesky_ex` reports a
    failed factorization in `info` instead of raising, and
    Σ⁻¹ = L⁻ᵀ L⁻¹ comes from a triangular solve, which has no error path.
    A lane whose factorization fails gets an all-NaN Σ⁻¹, so it dies
    fail-safe (its ll goes non-finite, run_cavi stops it and restart
    selection masks it), as the JAX package's unrolled Cholesky does through
    the sqrt of a negative pivot."""
    L, info = torch.linalg.cholesky_ex(Sigma)
    eye = torch.eye(Sigma.shape[-1], dtype=Sigma.dtype, device=Sigma.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    inv = Linv.mT @ Linv
    return torch.where((info != 0)[..., None, None], torch.nan, inv)


def update_Sigma_mats(lam, nu, mu, D):
    """Σ = (Σ_d diag(ν_d) + (λ_d-μ)(λ_d-μ)ᵀ)/D and Σ⁻¹ (src/MMCTM.jl:204-212)."""
    E = lam - mu.unsqueeze(-2)
    Sigma = (torch.diag_embed(nu.sum(dim=-2)) + E.mT @ E) / D
    return Sigma, spd_inverse(Sigma)


def props_from_lam(lam: torch.Tensor, config) -> Tuple[torch.Tensor, ...]:
    """Per-modality doc-topic proportions: softmax of λ's block
    (src/MMCTM.jl:145-154). Tuple of (R, D, K_m)."""
    return tuple(torch.softmax(config.block(lam, m), dim=-1) for m in range(config.M))


def _select_lanes(keep: torch.Tensor, new, old):
    """Per-lane torch.where over a state (tensors and tuples of tensors)."""
    if isinstance(new, tuple):
        parts = [_select_lanes(keep, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    return torch.where(keep.view(-1, *([1] * (new.dim() - 1))), new, old)


def run_cavi(state, config, maxiter: int, tol: float, step_fn):
    """The CAVI loop: a host loop with the reference's convergence rule
    (relative Δ of the (M,) ll vector < tol after iteration 10;
    src/common.jl:48-56), per restart lane.

    Every lane steps every iteration; a finished lane is frozen with
    torch.where, exactly as the vmapped `lax.while_loop` of the JAX package
    freezes it, so results do not depend on when the loop notices that all
    lanes are done (it reads `done.all()` every DONE_CHECK_EVERY
    iterations, and nowhere else waits on the device). A lane whose ll goes
    non-finite stops too (a dead lane can never recover); `carry_converged`
    reports it as not converged.

    Returns (state, ll_buf (R, maxiter, M), n_iters (R,), done (R,))."""
    R = state.lam.shape[0]
    device = state.lam.device
    ll_buf = torch.zeros((R, maxiter, config.M), dtype=config.dtype, device=device)
    n_iters = torch.zeros(R, dtype=torch.int64, device=device)
    done = torch.zeros(R, dtype=torch.bool, device=device)
    for it in range(maxiter):
        new_state, ll_i = step_fn(state)
        active = ~done
        state = _select_lanes(active, new_state, state)
        ll_buf[:, it] = torch.where(active[:, None], ll_i, ll_buf[:, it])
        n_iters = n_iters + active
        stop = ~torch.isfinite(ll_i).all(dim=-1)
        if it + 1 > MIN_ITERS_BEFORE_CONVERGENCE:
            # ll_buf[:, -1] at it = 0 wraps, as in the JAX loop
            stop = stop | (relative_change(ll_buf[:, it - 1], ll_i) < tol)
        done = done | (active & stop)
        if (it + 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
    return state, ll_buf, n_iters, done


def carry_converged(ll_buf, n_iters, done):
    """True convergence for reporting: terminated AND the final ll finite."""
    last = ll_buf[torch.arange(ll_buf.shape[0], device=ll_buf.device), n_iters - 1]
    return done & torch.isfinite(last).all(dim=-1)


def elbo_eta_z_term_dict(lam, nu, zeta, mu, invSigma, sumtheta, N, config):
    """The logistic-normal ELBO pieces {ElnPeta, ElnPZ, ElnQeta}, each (R,)
    (src/MMCTM.jl:286-318, 354-360)."""
    D, MK = config.D, config.MK
    log2pi = math.log(2 * math.pi)
    Ediff = lam - mu.unsqueeze(-2)
    L, _ = torch.linalg.cholesky_ex(invSigma)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    quad = (Ediff * (Ediff @ invSigma)).sum(dim=(-2, -1))
    trace = (nu * torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2)).sum(dim=(-2, -1))
    ElnPeta = 0.5 * (D * logdet - D * MK * log2pi - trace - quad)

    Eeta = torch.exp(lam + 0.5 * nu)
    Ndivzeta = calculate_Ndivzeta(N, zeta, config)
    ElnPZ = (
        (lam * sumtheta).sum(dim=(-2, -1))
        - ((Ndivzeta * Eeta).sum(dim=(-2, -1)) - N.sum())
        - (N * torch.log(zeta)).sum(dim=(-2, -1))
    )
    ElnQeta = -0.5 * (torch.log(nu).sum(dim=(-2, -1)) + D * MK * (log2pi + 1.0))
    return {"ElnPeta": ElnPeta, "ElnPZ": ElnPZ, "ElnQeta": ElnQeta}
