"""Logistic-normal CTM machinery for the MMCTM fit, in PyTorch.

Counterpart of multimodalmusig_tpu/models/ctm_base.py. Restarts are a
written-out leading dimension R instead of a `vmap`: λ/ν are (R, D, MK),
ζ (R, D, M), μ (R, MK), Σ/Σ⁻¹ (R, MK, MK); the counts X (a tuple of
(D, V_m)) and N (D, M) are shared by every lane.

The functions that sum over the documents take an optional `reduce`, the
hook of a data-parallel fit (parallel/sharding.py `DocSum`), where each
process holds a slice of the documents and the config's D is the global
count: `reduce(tensors)` returns each tensor summed over every slice, the
same on every process, and `reduce.agree(done)` returns the first
process's flags, so that every process stops at the same iteration. The
functions that sum over the vocabulary take an optional `vocab_reduce`,
the same kind of hook for a vocab-sharded fit (parallel/sharding.py
`sharded_vocab_parallel_fit`), where each process holds a contiguous slice
of every modality's vocabulary (its columns of X) and the config's V is
the global count. With no hook each of them computes exactly what it
computed before the hooks existed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import estep_kernel, flags, lambda_kernel, ll_kernel, theta_kernel
from ..ops.convergence import MIN_ITERS_BEFORE_CONVERGENCE, relative_change
from ..ops.solvers import (
    CG_F32_CAVI,
    LAMBDA_NITER_F32_CAVI,
    LAMBDA_POLISH_F32_CAVI,
    NU_FP_F32_CAVI,
    extrapolated_start,
    maximize_lambda,
    maximize_nu,
)
from ..utils import graphs, profiling

__all__ = [
    "CTMBaseConfig",
    "full_f32_matmuls",
    "counts_per_doc",
    "calculate_Ndivzeta",
    "calculate_sumtheta",
    "theta_moments_one",
    "theta_moments",
    "theta_from",
    "update_zeta",
    "solve_nu",
    "resolved_budgets",
    "solve_lambda",
    "solve_eta",
    "split_eta",
    "check_device",
    "update_mu_vec",
    "update_Sigma_mats",
    "spd_inverse",
    "props_from_lam",
    "lanes_of",
    "make_cavi_carry",
    "run_cavi_from",
    "run_cavi",
    "carry_converged",
    "elbo_eta_z_term_dict",
    "elbo_eta_z_terms",
    "DONE_CHECK_EVERY",
    "FrozenTopics",
    "update_mu_Sigma",
    "transform_states",
    "fit_heldout_states",
    "conditional_eta",
    "predict_modality_eta_states",
]

# The CAVI host loop reads `done.all()` (a device→host sync) once per this
# many iterations. Finished lanes are frozen, so the value changes only how
# many wasted iterations may follow the last lane's convergence, never the
# results.
DONE_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class CTMBaseConfig:
    """Static per-modality topic/vocab structure. The inner-solver budgets
    default (None) to the dtype-dependent values of `resolved_budgets`.

    Two options of the λ solve, the JAX package's (its ctm_base.py:61-76),
    set with `dataclasses.replace(config, ...)`:
      * `lambda_extrap` (None or 0: off): the fit and inference loops start
        the λ solve at the secant step λ + clamp(c·(λ − λ_prev), ±4), λ_prev
        the previous iteration's λ (the state's lam_pre), instead of at λ;
        ζ and ν still read λ (`solve_eta`). The η kernel forms that start
        itself, so the option keeps the fused route;
      * `lambda_solver`: the Newton direction, None or "pcg" (Jacobi PCG),
        or "chol" (a direct Cholesky solve, ops/solvers._chol_solve), which
        the kernels do not implement: it takes the split η route and the
        plain λ solver on every device (`_eta_route`, `_lambda_route`)."""

    K: Tuple[int, ...]  # topics per modality
    V: Tuple[int, ...]  # vocab items per modality
    D: int              # documents
    dtype: torch.dtype = torch.float32
    lambda_n_iter: Optional[int] = None
    lambda_cg_iter: Optional[int] = None
    lambda_polish_iter: Optional[int] = None
    nu_n_iter: Optional[int] = None
    lambda_extrap: Optional[float] = None
    lambda_solver: Optional[str] = None

    @property
    def M(self) -> int:
        return len(self.K)

    @property
    def ll_shape(self) -> Tuple[int, ...]:
        """The shape of one lane's ll: one value per modality."""
        return (self.M,)

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


def counts_per_doc(X, vocab_reduce=None) -> torch.Tensor:
    """N[d, m] = total counts of document d in modality m (src/MMCTM.jl:37).
    With `vocab_reduce`, X holds this process's vocabulary slice and N is
    reduced over every slice."""
    N = torch.stack([Xm.sum(dim=1) for Xm in X], dim=1)
    if vocab_reduce is not None:
        (N,) = vocab_reduce([N])  # V-reduction: the counts per document
    return N


def calculate_Ndivzeta(N: torch.Tensor, zeta: torch.Tensor, config) -> torch.Tensor:
    """(R, D, MK): N_dm/ζ_dm broadcast to modality m's topic block
    (src/MMCTM.jl:119-125)."""
    ratio = N / zeta
    return torch.cat(
        [ratio[..., m : m + 1].expand(*ratio.shape[:-1], config.K[m]) for m in range(config.M)],
        dim=-1,
    )


def calculate_sumtheta(theta, X, config) -> torch.Tensor:
    """(R, D, MK): the count-weighted θ sums Σ_v X[d, v]·θ[r, d, v, k] of a
    materialized θ (`theta_from`), concatenated over the modalities
    (src/MMCTM.jl:110-117). The fit loops take them from `theta_moments`
    without θ."""
    return torch.cat([torch.einsum("dv,rdvk->rdk", X[m], theta[m]) for m in range(config.M)],
                     dim=-1)


def _theta_route(device_type: str, dtype: torch.dtype, V: int, K: int) -> str:
    """How `theta_moments` computes one modality: "kernel" (the fused CUDA
    kernel, ops/theta_kernel.py) for CUDA float32 with V ≤ 128 and K ≤ 128,
    the TPU kernel's limits; "factorized" (the JAX package's production
    schedule) for everything else."""
    if (device_type == "cuda" and dtype == torch.float32
            and V <= theta_kernel.THETA_MAX_V and K <= theta_kernel.THETA_MAX_K):
        return "kernel"
    return "factorized"


def _ll_route(device_type: str, dtype: torch.dtype, K, V) -> str:
    """How `mmctm.modality_loglikelihoods` sums the mixture log-likelihoods
    of modalities with topics K and items V: "kernel" (the fused CUDA
    kernel, ops/ll_kernel.py, which never stores the (R, D, V) mixture) for
    CUDA float32 within the kernel's limits (M ≤ 16, every K ≤ 128 and
    V ≤ 128); "plain" (`ll_kernel.mixture_lls_plain`, the PyTorch
    expression) for CPU tensors, CUDA float64 and larger shapes."""
    if (device_type == "cuda" and dtype == torch.float32 and len(K) <= ll_kernel.LL_MAX_M
            and max(K) <= ll_kernel.LL_MAX_K and max(V) <= ll_kernel.LL_MAX_V):
        return "kernel"
    return "plain"


def theta_moments_one(lam_block, logw, X, want_scatter: bool = True):
    """One modality's count-weighted θ moments without materializing θ:
    θ[r,d,v,:] = softmax(lam_block[r,d,:] + logw[r,v,:]) for lam_block
    (R, D, K), logw (R, V, K) and X (D, V) shared by the lanes ->
    (sumθ (R, D, K), scatter (R, K, V), or None when `want_scatter` is
    False). `_theta_route` picks the schedule:
      * "kernel": the fused CUDA kernel, which forms each cell's softmax in
        registers with the joint max of its (d, v) logits, as the TPU kernel
        does (tools/pallas_experiments/theta_kernel.py). That closes the
        factorized schedule's f32 underflow gap (JAX ctm_base.py:152-165): a
        cell whose every topic sits > ~88 nats below a_d + b_v keeps finite
        moments instead of stopping its lane as NaN. No BRCA result changes;
        spreads there are tens of nats. It computes the scatter either way,
        as the TPU kernel does, and drops it when not wanted;
      * "factorized": θ[d,v,k] = softmax_k(λ_dk + w_vk) factors exactly: with
        A = exp(λ_block − max_k λ_block) and B = exp(w − max_k w),
        Z = A Bᵀ (D, V), R = X / Z, sumθ = A ⊙ (R B) and
        scatter = (B ⊙ (Rᵀ A))ᵀ — three batched matmuls, the last skipped
        without `want_scatter` (ctm_base.py:132-202 of the JAX package
        documents the math and its f32 underflow gap, which fails safe: the
        lane's ll goes non-finite and the lane stops).
    The route is a shape rule, not an error path: a kernel that fails to
    build or launch raises. The LDA and ILDA E-steps call this with
    (E[ln θ], the topic log-weights)."""
    if _theta_route(lam_block.device.type, lam_block.dtype, X.shape[-1],
                    lam_block.shape[-1]) == "kernel":
        sumtheta, scatter = theta_kernel.theta_moments_fused(lam_block, logw, X)
        return sumtheta, scatter if want_scatter else None
    A = torch.exp(lam_block - lam_block.amax(dim=-1, keepdim=True))     # (R, D, K)
    B = torch.exp(logw - logw.amax(dim=-1, keepdim=True))               # (R, V, K)
    Rm = X / (A @ B.mT)                                                 # (R, D, V)
    return A * (Rm @ B), (B * (Rm.mT @ A)).mT if want_scatter else None


def theta_moments(lam, logw, X, config, want_scatter: bool = True, vocab_reduce=None):
    """Both count-weighted θ moments of every modality, `theta_moments_one`
    per modality block of λ: (sumθ (R, D, MK), scatters tuple of
    (R, K_m, V_m), or None when `want_scatter` is False, as in the inference
    loops, which keep the topics frozen). With `vocab_reduce`, logw and X
    hold this process's vocabulary slice: sumθ is reduced over every slice,
    and each scatter keeps the slice's own columns."""
    sum_parts, scatters = [], []
    for m in range(config.M):
        sumtheta_m, scatter_m = theta_moments_one(config.block(lam, m), logw[m], X[m],
                                                  want_scatter)
        sum_parts.append(sumtheta_m)
        scatters.append(scatter_m)
    sumtheta = torch.cat(sum_parts, dim=-1)
    if vocab_reduce is not None:
        (sumtheta,) = vocab_reduce([sumtheta])  # V-reduction: sumθ for the η side
    return sumtheta, tuple(scatters) if want_scatter else None


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


def solve_nu(nu, lam, Ndivzeta, invSigma, n_iter=None):
    """The batched ν solve (replaces NLopt at src/MMCTM.jl:156-170) with
    diag(Σ⁻¹) of each lane: Σ⁻¹ (R, MK, MK) against ν, λ, N/ζ (R, D, MK)."""
    kw = {} if n_iter is None else {"n_iter": n_iter}
    return maximize_nu(nu, lam, Ndivzeta,
                       torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2), **kw)


def resolved_budgets(config) -> dict:
    """The inner-solver budgets a fit with this config runs:
    {"lambda_n_iter", "lambda_cg_iter", "lambda_polish_iter", "nu_n_iter"},
    None meaning the solver's own cold-start default. Float32 fits take the
    warm-start caps measured in the JAX package (Newton 3, PCG 4, polish 1,
    ν sweeps 4) unless MUSIG_F32_FULL_BUDGETS=1 (`flags.F32_FULL_BUDGETS`,
    read here at each call); float64 keeps the full budgets. Config fields
    always win."""
    f32 = config.dtype == torch.float32 and not flags.F32_FULL_BUDGETS
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


def _lambda_route(device_type: str, dtype: torch.dtype, MK: int, solver=None) -> str:
    """How `solve_lambda` solves: "kernel" (the fused CUDA kernel,
    ops/lambda_kernel.py, f32 like the TPU kernel it replaces) for CUDA
    float32 with MK ≤ 128, the JAX package's rule (JAX ctm_base.py:317);
    "plain" (ops/solvers.maximize_lambda) for CPU tensors, CUDA float64 and
    MK > 128. A `solver` (CTMBaseConfig.lambda_solver) other than None or
    "pcg" is "plain" on every device: the kernel implements the PCG
    direction only, and "chol" is the user's explicit choice of the plain
    solver, not a fallback (JAX ctm_base.py:312-316)."""
    if solver not in (None, "pcg"):
        return "plain"
    if device_type == "cuda" and dtype == torch.float32 and MK <= lambda_kernel.KERNEL_MAX_MK:
        return "kernel"
    return "plain"


def solve_lambda(lam, nu, Ndivzeta, sumtheta, mu, invSigma,
                 n_iter=None, cg_iter=None, polish_iter=None, solver=None):
    """Batched λ maximization (replaces NLopt at src/MMCTM.jl:127-143) over
    (R, D, MK) with per-lane μ (R, MK) and Σ⁻¹ (R, MK, MK), routed by
    `_lambda_route`; `solver` is the Newton direction (None: "pcg"). The
    route is a shape rule, not an error path: a kernel that fails to build
    or launch raises."""
    kw = {"n_iter": n_iter, "cg_iter": cg_iter, "polish_iter": polish_iter}
    kw = {k: int(v) for k, v in kw.items() if v is not None}
    if _lambda_route(lam.device.type, lam.dtype, lam.shape[-1], solver) == "kernel":
        return lambda_kernel.maximize_lambda_restarts(
            lam, nu, Ndivzeta, sumtheta, mu, invSigma, **kw
        )
    if solver is not None:
        kw["solver"] = str(solver)
    return maximize_lambda(lam, nu, Ndivzeta, sumtheta, mu, invSigma, **kw)


def _eta_route(device_type: str, dtype: torch.dtype, MK: int, solver=None) -> str:
    """How `solve_eta` computes the η side: "fused" (the fused CUDA kernel,
    ops/estep_kernel.py: ζ, N/ζ, ν and λ in one launch) for CUDA float32
    with MK ≤ 128; "split" (ζ, N/ζ and the ν solve in PyTorch, then
    `solve_lambda`, which `_lambda_route` sends to the λ kernel or the plain
    solver) for CPU tensors, CUDA float64 and MK > 128. A `solver`
    (CTMBaseConfig.lambda_solver) other than None or "pcg" is "split" on
    every device, and `_lambda_route` then sends it to the plain solver:
    the user's explicit choice of a direction the kernels do not implement,
    not a fallback, so such a fit launches neither the η nor the λ kernel
    (JAX ctm_base.py:312-316)."""
    if solver not in (None, "pcg"):
        return "split"
    if device_type == "cuda" and dtype == torch.float32 and MK <= estep_kernel.KERNEL_MAX_MK:
        return "fused"
    return "split"


def solve_eta(lam, nu, N, sumtheta, mu, invSigma, config, lam_prev=None):
    """The η side of one batched `fitdoc!` (src/MMCTM.jl:450-455, minus θ):
    ζ (closed form) → N/ζ → ν solve → λ solve, for every lane and document,
    routed by `_eta_route`. ζ and N/ζ come from the incoming λ and ν, the ν
    solve reads the incoming λ, and the λ solve starts, with the new ν, from
    `ops/solvers.extrapolated_start(λ, lam_prev, config.lambda_extrap)`:
    the incoming λ itself unless the config's lambda_extrap is set and
    `lam_prev` (the previous iteration's λ, the state's lam_pre) is given
    (the JAX package's solve_eta, its ctm_base.py:363-412). On the fused
    route the η kernel forms that start. The route is a shape rule, not an
    error path: a kernel that fails to build or launch raises. Returns
    (ζ, ν', λ')."""
    budgets = resolved_budgets(config)
    # the secant start's arguments only where it is on, else no argument
    start = ({"lam_prev": lam_prev, "extrap": float(config.lambda_extrap)}
             if config.lambda_extrap and lam_prev is not None else {})
    if _eta_route(lam.device.type, lam.dtype, lam.shape[-1], config.lambda_solver) == "fused":
        kw = {
            kernel_name: budgets[field]
            for kernel_name, field in (
                ("n_iter", "lambda_n_iter"), ("cg_iter", "lambda_cg_iter"),
                ("polish_iter", "lambda_polish_iter"), ("nu_n_iter", "nu_n_iter"),
            )
            if budgets[field] is not None
        }
        return estep_kernel.estep_eta_fused(lam, nu, N, sumtheta, mu, invSigma, config.K,
                                            **kw, **start)
    solver = {} if config.lambda_solver is None else {"solver": config.lambda_solver}
    return split_eta(
        lam, nu, N, sumtheta, mu, invSigma, config, solve_lambda, nu_n_iter=budgets["nu_n_iter"],
        n_iter=budgets["lambda_n_iter"], cg_iter=budgets["lambda_cg_iter"],
        polish_iter=budgets["lambda_polish_iter"], **start, **solver,
    )


def split_eta(lam, nu, N, sumtheta, mu, invSigma, config, lambda_solver, nu_n_iter=None,
              lam_prev=None, extrap=None, **lambda_kw):
    """The η side as separate steps: ζ and N/ζ from the incoming λ and ν,
    the ν solve from the incoming λ (`nu_n_iter` sweeps, None: the
    solver's default), then `lambda_solver(λ₀, ν', N/ζ, sumθ, μ, Σ⁻¹,
    **lambda_kw)` with the new ν, from λ₀ = extrapolated_start(λ, lam_prev,
    extrap) (λ itself without both). `solve_eta`'s "split" route passes
    `solve_lambda`; the η kernel's plain version passes the plain
    `maximize_lambda`. Returns (ζ, ν', λ')."""
    zeta = update_zeta(lam, nu, config)
    Ndivzeta = calculate_Ndivzeta(N, zeta, config)
    diag = torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2)
    nu_kw = {} if nu_n_iter is None else {"n_iter": nu_n_iter}
    nu2 = maximize_nu(nu, lam, Ndivzeta, diag, **nu_kw)
    lam0 = extrapolated_start(lam, lam_prev, extrap)
    return zeta, nu2, lambda_solver(lam0, nu2, Ndivzeta, sumtheta, mu, invSigma, **lambda_kw)


def check_device(device) -> torch.device:
    """`device` as a torch.device. A CUDA device needs a card: without one
    this raises rather than fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available; the fits run on the card by default, "
            'pass device="cpu" to run on the CPU'
        )
    return device


def update_mu_vec(lam: torch.Tensor, reduce=None, D: Optional[int] = None) -> torch.Tensor:
    """μ = mean_d λ_d (src/MMCTM.jl:200-202): (R, D, MK) -> (R, MK). With
    `reduce`, λ holds this process's documents and μ is their reduced sum
    over the global document count D."""
    if reduce is None:
        return lam.mean(dim=-2)
    (total,) = reduce([lam.sum(dim=-2)])  # D-reduction: μ's sum over documents
    return total / D


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


def update_Sigma_mats(lam, nu, mu, D, reduce=None):
    """Σ = (Σ_d diag(ν_d) + (λ_d-μ)(λ_d-μ)ᵀ)/D and Σ⁻¹ (src/MMCTM.jl:204-212).
    With `reduce`, the sum over this process's documents is reduced before
    the division by the global D; every process then inverts the same Σ."""
    E = lam - mu.unsqueeze(-2)
    scatter = torch.diag_embed(nu.sum(dim=-2)) + E.mT @ E
    if reduce is not None:
        (scatter,) = reduce([scatter])  # D-reduction: Σ's sum over documents
    Sigma = scatter / D
    return Sigma, spd_inverse(Sigma)


def props_from_lam(lam: torch.Tensor, config) -> Tuple[torch.Tensor, ...]:
    """Per-modality doc-topic proportions: softmax of λ's block
    (src/MMCTM.jl:145-154). Tuple of (R, D, K_m)."""
    return tuple(torch.softmax(config.block(lam, m), dim=-1) for m in range(config.M))


def lanes_of(state) -> Tuple[int, torch.device]:
    """(lanes R, device) of a batched state of any family, read from its γ
    (a tensor, or a nested tuple of them, each with the lanes first)."""
    gamma = state.gamma
    while isinstance(gamma, tuple):
        gamma = gamma[0]
    return gamma.shape[0], gamma.device


def make_cavi_carry(state, config, maxiter: int):
    """A fresh CAVI carry for every lane of `state`: (state, ll_buf
    (R, maxiter, *config.ll_shape) of zeros — (R, maxiter, M) for the CTM
    families, (R, maxiter) for LDA and ILDA — n_iters (R,) of zeros, done
    (R,) all False). `done` is a termination flag: true on convergence or
    when the lane's ll went non-finite; `carry_converged` tells the two
    apart."""
    R, device = lanes_of(state)
    return (
        state,
        torch.zeros((R, maxiter, *config.ll_shape), dtype=config.dtype, device=device),
        torch.zeros(R, dtype=torch.int64, device=device),
        torch.zeros(R, dtype=torch.bool, device=device),
    )


def _per_lane(t: torch.Tensor) -> torch.Tensor:
    """An (R, ...) ll as (R, width): one row per lane."""
    return t.reshape(t.shape[0], -1)


class _LaneFreeze:
    """The lane freeze of one `run_cavi_from` call, over device tensors
    only, so that a CUDA graph can replay it (utils/graphs.py): after each
    step the lanes still running (`active`: not done before the step) take
    the step's state and ll, count the iteration and test for convergence,
    and the others keep theirs, with torch.where, as the vmapped
    `lax.while_loop` of the JAX package freezes them.

    It writes in place into the call's own copy of the carry: the state's
    fields, n_iters and done are cloned when the call starts, and ll_buf is
    written in place, as it always was. The iteration is a device scalar:
    the ll row is written at `it` and read at (it - 1) mod maxiter, which
    wraps at it = 0 as the JAX loop does, and the convergence test's gate,
    it + 1 > MIN_ITERS_BEFORE_CONVERGENCE, is a device comparison.

    A field of the step's new state may share memory with another field
    of the carry: the E-step's lam_pre is the carry's λ, its logw_pre the
    carry's E[ln ϕ] (LDA's, its E[ln β]). Such a field is written before the
    field it reads; a field that is the carry's own is left as it is."""

    def __init__(self, carry, it0: int, maxiter: int, tol: float):
        state, ll_buf, n_iters, done = carry
        self.state = _map_tree(torch.clone, state)
        self.fields = graphs.leaves(self.state)
        self.ll_buf, self.n_iters, self.done = ll_buf, n_iters.clone(), done.clone()
        self.active = torch.empty_like(self.done)
        self.it = torch.full((), it0, dtype=torch.int64, device=ll_buf.device)
        self.maxiter, self.tol = maxiter, tol
        self._field_of = {f.untyped_storage().data_ptr(): i for i, f in enumerate(self.fields)}

    def buffers(self) -> list:
        """The tensors the freeze writes in place."""
        return [*self.fields, self.ll_buf, self.n_iters, self.done, self.active, self.it]

    def carry(self):
        return self.state, self.ll_buf, self.n_iters, self.done

    def _order(self, new) -> list:
        """The indices of the new fields to write, each carry field read
        before it is overwritten."""
        if len(new) != len(self.fields):
            raise ValueError("a step returned a state of another structure than its carry")
        first, rest, read = [], [], set()
        for i, (x, old) in enumerate(zip(new, self.fields)):
            j = self._field_of.get(x.untyped_storage().data_ptr())
            if j is None:
                rest.append(i)
            elif j != i:
                first.append(i)
                read.add(j)
            elif x.data_ptr() != old.data_ptr() or x.stride() != old.stride():
                raise ValueError("a step returned another view of a carry field in its place")
        if read.intersection(first):
            raise ValueError("the fields of a step's new state read each other's carry fields")
        return first + rest

    def __call__(self, new_state, ll_i) -> None:
        new = graphs.leaves(new_state)
        active = torch.logical_not(self.done, out=self.active)
        for i in self._order(new):
            old = self.fields[i]
            torch.where(_lanes_view(active, old), new[i], old, out=old)
        it = self.it.view(1)
        ll = ll_i.unsqueeze(1)
        row = self.ll_buf.index_select(1, it)
        self.ll_buf.index_copy_(1, it, torch.where(_lanes_view(active, ll), ll, row))
        self.n_iters.add_(active)
        stop = ~torch.isfinite(_per_lane(ll_i)).all(dim=-1)
        prev = self.ll_buf.index_select(1, (it - 1) % self.maxiter).squeeze(1)
        converged = relative_change(_per_lane(prev), _per_lane(ll_i)) < self.tol
        stop |= (self.it + 1 > MIN_ITERS_BEFORE_CONVERGENCE) & converged
        self.done |= active & stop
        self.it += 1


def _lanes_view(keep: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane flag (R,) shaped to broadcast over `like` (R, ...)."""
    return keep.view(-1, *([1] * (like.dim() - 1)))


def run_cavi_from(carry, maxiter: int, tol: float, step_fn, max_new_iters=None,
                  verbose: bool = False, verbose_label: str = "Log-likelihoods", reduce=None):
    """Resume the CAVI loop from `carry` for up to `max_new_iters` more
    iterations (None: up to maxiter in all), with the reference's
    convergence rule (relative Δ of the lane's ll, the (M,) vector or LDA's
    scalar, < tol after iteration 10; src/common.jl:48-56), per restart
    lane.

    `verbose` prints each iteration's lls while a lane still runs, as
    "<iteration>\t<verbose_label>: <lls>" (one lane's lls at R = 1, the
    array of every lane else), the line of the JAX package's loop, which
    labels it "Log-likelihoods" for the CTM families and "Log-likelihood"
    for LDA and ILDA. That reads the lls and `done` on the host every
    iteration, so a verbose loop also stops as soon as every lane is done;
    without `verbose` the loop makes no read but the periodic `done.all()`.

    Every lane steps every iteration; a finished lane is frozen
    (`_LaneFreeze`), so results do not depend on when the loop notices that
    all lanes are done (it reads `done.all()` every DONE_CHECK_EVERY
    iterations) nor on how a fit is cut into calls. A lane whose ll goes
    non-finite stops too (a dead lane can never recover); `carry_converged`
    reports it as not converged. The call leaves `carry`'s state, n_iters
    and done as they were; its ll_buf takes the new rows.

    The call is one segment of CUDA graphs (utils/graphs.py) when the carry
    is on the card: the freeze runs eagerly at the first step, is captured
    at the second and replayed after that, and the step's own chains (the
    MMCTM step's tail) do the same. The segment's graphs are released when
    the call returns.

    The lanes still running must share one iteration count, as they do in a
    fresh carry and in the survivors of a compaction boundary (which all ran
    the whole phase); reading it is this call's one device→host sync before
    the loop. With `reduce` (a data-parallel or vocab-sharded fit's hook)
    the loop stops on the first process's `done`, so no process leaves a
    collective that the others still enter. Returns the new carry."""
    _, ll_buf, n_iters, done = carry
    lanes = ll_buf.shape[0]
    t = profiling.begin("loop.sync") if profiling.ON else None
    running = n_iters[~done].unique().tolist()
    if t is not None:
        profiling.end(t)
        profiling.count("loop.syncs")
    if len(running) > 1:
        raise ValueError(f"the running lanes are at different iterations {running}")
    it0 = running[0] if running else maxiter
    it_end = maxiter if max_new_iters is None else min(maxiter, it0 + int(max_new_iters))
    if it0 >= it_end:
        return carry
    freeze = _LaneFreeze(carry, it0, maxiter, tol)
    with graphs.segment(ll_buf.device, freeze.buffers()) as seg:
        graph = None if seg is None else seg.chain("freeze", freeze)
        for it in range(it0, it_end):
            new_state, ll_i = step_fn(freeze.state)
            t = profiling.begin("loop.freeze") if profiling.ON else None
            if graph is not None and graph.warm:
                graph(new_state, ll_i)
            else:
                freeze(new_state, ll_i)
                if graph is not None:
                    graph.warm = True
            if t is not None:
                profiling.end(t)
                profiling.count("loop.steps")
                profiling.count("loop.lane_steps", lanes)
            if not verbose and (it + 1) % DONE_CHECK_EVERY != 0:
                continue
            t = profiling.begin("loop.sync") if profiling.ON else None
            if verbose and bool(freeze.active.any()):
                lls = ll_i[0] if ll_i.shape[0] == 1 else ll_i
                print(f"{it + 1}\t{verbose_label}: {lls.cpu().numpy()}")
            if reduce is not None:
                freeze.done.copy_(reduce.agree(freeze.done))
            finished = bool(freeze.done.all())
            if t is not None:
                profiling.end(t)
                profiling.count("loop.syncs")
            if finished:
                break
    return freeze.carry()


def _map_tree(fn, tree):
    """`fn` of every tensor of a (nested) state or carry, in its structure."""
    if isinstance(tree, tuple):
        parts = [_map_tree(fn, x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree)


def _index_lanes(tree, idx: torch.Tensor):
    """Lanes `idx` of every tensor of a (nested) state or carry."""
    return _map_tree(lambda t: t.index_select(0, idx), tree)


def _cat_lanes(trees):
    """Concatenate a list of (nested) states or carries along the lanes."""
    first = trees[0]
    if isinstance(first, tuple):
        parts = [_cat_lanes([t[i] for t in trees]) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return torch.cat(trees, dim=0)


def run_cavi(state, config, maxiter: int, tol: float, step_fn, compact_schedule=(),
             progress=None, verbose: bool = False, verbose_label: str = "Log-likelihoods",
             reduce=None):
    """The whole CAVI loop over every lane of `state`, from a fresh carry.
    Returns (state, ll_buf (R, maxiter, *config.ll_shape), n_iters (R,),
    done (R,)).

    `compact_schedule=(c1, c2, ...)` is straggler compaction (restarts.py:
    67-204 and 1088-1187 of the JAX package): every lane runs c1
    iterations, then the finished lanes (done, or at maxiter) leave the
    batch and the survivors, gathered with index_select on every state
    field, run c2 more, and so on; once the schedule is spent the survivors
    run to their end. Any iterable of budgets will do, an endless
    `itertools.repeat(chunk_iters)` included: it is read one budget per
    boundary. The finished groups come back in restart order. Finished
    lanes are frozen either way, so each lane's result does not depend on
    the schedule. The JAX package pads each survivor batch to a power of
    two, because each batch size there is a compiled executable of its own;
    eager PyTorch compiles nothing per shape, so nothing is padded. Each
    boundary reads the (n_iters, done) vectors on the host (one sync); an
    empty (or None) schedule is one uncut `run_cavi_from`.

    `progress(done, total)` is called at every boundary and once at the
    end, with the number of finished lanes (converged, non-finite or at
    maxiter) out of R; an uncut fit calls it once, with (R, R). `verbose`,
    `verbose_label` and `reduce` are `run_cavi_from`'s.

    An entry point of the tracer (utils/profiling.py): the span `loop.run`,
    and `loop.boundary` around each boundary's host work (after every
    segment the (n_iters, done) read and the gathers; after the last one
    the read and the final gather, so an uncut loop has one)."""
    with profiling.entry("loop.run"):
        return _run_segments(state, config, maxiter, tol, step_fn, compact_schedule, progress,
                             dict(verbose=verbose, verbose_label=verbose_label, reduce=reduce))


def _run_segments(state, config, maxiter, tol, step_fn, compact_schedule, progress, loud):
    """`run_cavi`'s loop: its segments and the boundaries between them."""
    carry = make_cavi_carry(state, config, maxiter)
    R, device = lanes_of(state)
    budgets = (int(c) for c in (() if compact_schedule is None else compact_schedule))
    order = np.arange(R)
    groups, group_orders = [], []
    carry = run_cavi_from(carry, maxiter, tol, step_fn, next(budgets, None), **loud)
    while True:
        b = profiling.begin("loop.boundary") if profiling.ON else None
        it, done = (t.cpu().numpy() for t in (carry[2], carry[3]))
        done = done | (it >= maxiter)
        done_pos, active_pos = np.nonzero(done)[0], np.nonzero(~done)[0]
        if progress is not None:
            progress(R - len(active_pos), R)
        if len(active_pos) == 0:
            groups.append(carry)
            group_orders.append(order)
            break
        budget = next(budgets, None)
        if len(done_pos) > 0:
            groups.append(_index_lanes(carry, torch.as_tensor(done_pos, device=device)))
            group_orders.append(order[done_pos])
            carry = _index_lanes(carry, torch.as_tensor(active_pos, device=device))
            order = order[active_pos]
        if b is not None:
            profiling.end(b)
            profiling.count("loop.boundaries")
        carry = run_cavi_from(carry, maxiter, tol, step_fn, budget, **loud)
    if len(groups) == 1:  # no lane left the batch: restart order already
        out = groups[0]
    else:
        inv = np.argsort(np.concatenate(group_orders))
        out = _index_lanes(_cat_lanes(groups), torch.as_tensor(inv, device=device))
    if b is not None:
        profiling.end(b)
        profiling.count("loop.boundaries")
    return out


def carry_converged(ll_buf, n_iters, done):
    """True convergence for reporting: terminated AND the final ll finite."""
    last = ll_buf[torch.arange(ll_buf.shape[0], device=ll_buf.device), n_iters - 1]
    return done & torch.isfinite(_per_lane(last)).all(dim=-1)


def _fit_result(result_type, carry, elbo):
    """A finished CAVI carry as a family's fit result `result_type` (its
    *FitResult), with the final ELBO `elbo` and each lane's final lls."""
    state, ll_buf, n_iters, done = carry
    lanes = torch.arange(ll_buf.shape[0], device=ll_buf.device)
    return result_type(state=state, ll_history=ll_buf, n_iters=n_iters,
                       converged=carry_converged(ll_buf, n_iters, done), elbo=elbo,
                       ll=ll_buf[lanes, n_iters - 1])


def _take_result(model, result) -> int:
    """Lane 0 of a fit result into a family's wrapper: state, converged,
    ELBO and the final ll (a list over the modalities for the CTM families,
    a float for LDA and ILDA). Returns the lane's iteration count."""
    model.state = result.state
    model.converged = bool(result.converged[0])
    model.elbo = float(result.elbo[0])
    ll = result.ll[0]
    model.ll = float(ll) if ll.dim() == 0 else [float(v) for v in ll.cpu()]
    return int(result.n_iters[0])


def elbo_eta_z_term_dict(lam, nu, zeta, mu, invSigma, sumtheta, N, config, reduce=None):
    """The logistic-normal ELBO pieces {ElnPeta, ElnPZ, ElnQeta}, each (R,)
    (src/MMCTM.jl:286-318, 354-360). With `reduce`, the document sums of
    this process's documents are reduced; D is the config's global count."""
    D, MK = config.D, config.MK
    log2pi = math.log(2 * math.pi)
    Ediff = lam - mu.unsqueeze(-2)
    L, _ = torch.linalg.cholesky_ex(invSigma)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    quad = (Ediff * (Ediff @ invSigma)).sum(dim=(-2, -1))
    trace = (nu * torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2)).sum(dim=(-2, -1))

    Eeta = torch.exp(lam + 0.5 * nu)
    Ndivzeta = calculate_Ndivzeta(N, zeta, config)
    ElnPZ = (
        (lam * sumtheta).sum(dim=(-2, -1))
        - ((Ndivzeta * Eeta).sum(dim=(-2, -1)) - N.sum())
        - (N * torch.log(zeta)).sum(dim=(-2, -1))
    )
    lognu = torch.log(nu).sum(dim=(-2, -1))
    if reduce is not None:
        # D-reductions: the quadratic and trace terms, ElnPZ (N.sum() in it)
        # and Σ log ν
        quad, trace, ElnPZ, lognu = reduce([quad, trace, ElnPZ, lognu])
    ElnPeta = 0.5 * (D * logdet - D * MK * log2pi - trace - quad)
    ElnQeta = -0.5 * (lognu + D * MK * (log2pi + 1.0))
    return {"ElnPeta": ElnPeta, "ElnPZ": ElnPZ, "ElnQeta": ElnQeta}


def elbo_eta_z_terms(lam, nu, zeta, mu, invSigma, theta, X, N, config):
    """ElnPη + ElnPZ − ElnQη, each lane's (R,), of a materialized θ
    (`theta_from`; the JAX package's elbo_eta_z_terms, its
    ctm_base.py:597-600): `elbo_eta_z_term_dict` with sumθ from
    `calculate_sumtheta`."""
    t = elbo_eta_z_term_dict(lam, nu, zeta, mu, invSigma, calculate_sumtheta(theta, X, config),
                             N, config)
    return t["ElnPeta"] + t["ElnPZ"] - t["ElnQeta"]


# ---------------------------------------------------------------------------
# Inference with the topics frozen (src/MMCTM.jl:496-634, src/IMMCTM.jl:468-545)
# ---------------------------------------------------------------------------


class FrozenTopics(NamedTuple):
    """What the inference loops take from a CTM family, its one-hot
    features (IMMCTM) bound:
      e_step(state, X, N, config, logw=, want_scatter=) -> (state, scatters);
      smoothed_logw(state, config): the log-weights of E[ln ϕ];
      unsmoothed_logw(gamma, config): the log-weights of ln ϕ, ϕ from γ;
      lls(gamma, X, config) -> a function of the state, its (R, M) lls
        under the topics `gamma`;
      finalize(carry, X, N, config): the family's fit result."""
    e_step: Callable
    smoothed_logw: Callable
    unsmoothed_logw: Callable
    lls: Callable
    finalize: Callable


def update_mu_Sigma(state, config, update_sigma: bool = True):
    """μ = mean λ, then (if update_sigma) Σ and Σ⁻¹ (src/MMCTM.jl:200-212)."""
    state = state._replace(mu=update_mu_vec(state.lam))
    if update_sigma:
        Sigma, invSigma = update_Sigma_mats(state.lam, state.nu, state.mu, config.D)
        state = state._replace(Sigma=Sigma, invSigma=invSigma)
    return state


def _frozen_loop(family: FrozenTopics, state, X, config, logw, maxiter: int, tol: float,
                 fit_gaussian: bool, verbose: bool):
    """run_cavi over the documents X with the topics frozen: each iteration
    the E-step with the fixed log-weights `logw` and no scatter, μ and Σ
    refit if `fit_gaussian`, and the lls under `state.gamma`. Returns
    (carry, N)."""
    N = counts_per_doc(X)
    lls = family.lls(state.gamma, X, config)

    def step(s):
        s, _ = family.e_step(s, X, N, config, logw=logw, want_scatter=False)
        if fit_gaussian:
            s = update_mu_Sigma(s, config)
        return s, lls(s)

    return run_cavi(state, config, maxiter, tol, step, verbose=verbose), N


def transform_states(family: FrozenTopics, trained, state, Xnew, config, maxiter: int,
                     tol: float, fit_gaussian: bool, verbose: bool):
    """Fold new documents into the trained point estimate ϕ
    (src/MMCTM.jl:511-552), every lane of `state` against the same lane of
    `trained`: θ from the frozen ln ϕ; γ and E[ln ϕ] copied from `trained`,
    so the returned ELBO is that of {trained topics, new posteriors}; μ, Σ
    and Σ⁻¹ = spd_inverse(trained Σ) copied unless `fit_gaussian`, which
    refits μ and Σ from the new documents every iteration."""
    Xnew = tuple(Xnew)
    with full_f32_matmuls():
        state = state._replace(gamma=trained.gamma, Elnphi=trained.Elnphi)
        if not fit_gaussian:
            state = state._replace(mu=trained.mu, Sigma=trained.Sigma,
                                   invSigma=spd_inverse(trained.Sigma))
        logw = family.unsmoothed_logw(trained.gamma, config)
        carry, N = _frozen_loop(family, state, Xnew, config, logw, maxiter, tol, fit_gaussian,
                                verbose)
        return family.finalize(carry, Xnew, N, config)


def fit_heldout_states(family: FrozenTopics, trained, state, Xheldout, config, maxiter: int,
                       tol: float, verbose: bool):
    """Refit the document side of held-out documents with the trained global
    posterior copied (μ, Σ, Σ⁻¹, γ, E[ln ϕ], α; src/MMCTM.jl:554-586): θ
    from the trained E[ln ϕ], the lls under the trained ϕ."""
    Xheldout = tuple(Xheldout)
    with full_f32_matmuls():
        state = state._replace(mu=trained.mu, Sigma=trained.Sigma, invSigma=trained.invSigma,
                               gamma=trained.gamma, Elnphi=trained.Elnphi, alpha=trained.alpha)
        logw = family.smoothed_logw(state, config)
        carry, N = _frozen_loop(family, state, Xheldout, config, logw, maxiter, tol, False,
                                verbose)
        return family.finalize(carry, Xheldout, N, config)


def _modality_split(config: CTMBaseConfig, m: int, device):
    """(unobserved, observed) topic indices of modality m's block and of
    the rest, as index tensors on `device`."""
    o = config.offsets[m]
    unobs = np.arange(o, o + config.K[m])
    obs = np.setdiff1d(np.arange(config.MK), unobs)
    return (torch.as_tensor(unobs, device=device), torch.as_tensor(obs, device=device))


def conditional_eta(trained, lam_obs, unobs, obs):
    """The reference's linear conditioning η = μ_u + Σ_uo·Σ⁻¹_oo·(λ − μ_o),
    with Σ⁻¹_oo the [obs, obs] block of the full inverse, not inv(Σ_oo)
    (src/MMCTM.jl:625-631): (R, D, K_u) from λ (R, D, MK − K_u)."""
    A = trained.Sigma[:, unobs][:, :, obs] @ trained.invSigma[:, obs][:, :, obs]
    return trained.mu[:, None, unobs] + (lam_obs - trained.mu[:, None, obs]) @ A.mT


def predict_modality_eta_states(family: FrozenTopics, trained, obs_state, Xobs, m: int, config,
                                obs_config, maxiter: int, tol: float, verbose: bool):
    """Cross-modality imputation (src/MMCTM.jl:588-634): fit the document
    side of the observed modalities (0-based `m` is the held-out one) with
    μ, Σ and Σ⁻¹ sliced to their [obs, obs] blocks and the observed γ and
    E[ln ϕ] copied from `trained`, then `conditional_eta`. `family` holds
    the observed modalities' features. Returns (η (R, D, K_m), the fitted
    observed state, converged (R,))."""
    unobs, obs = _modality_split(config, m, trained.mu.device)
    Xobs = tuple(Xobs)
    with full_f32_matmuls():
        obs_state = obs_state._replace(
            mu=trained.mu[:, obs],
            Sigma=trained.Sigma[:, obs][:, :, obs],
            invSigma=trained.invSigma[:, obs][:, :, obs],
            gamma=tuple(g for i, g in enumerate(trained.gamma) if i != m),
            Elnphi=tuple(e for i, e in enumerate(trained.Elnphi) if i != m),
        )
        logw = family.smoothed_logw(obs_state, obs_config)
        (obs_state, ll_buf, n_iters, done), _ = _frozen_loop(
            family, obs_state, Xobs, obs_config, logw, maxiter, tol, False, verbose)
        eta = conditional_eta(trained, obs_state.lam, unobs, obs)
    return eta, obs_state, carry_converged(ll_buf, n_iters, done)
