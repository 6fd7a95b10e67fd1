"""Batched maximizers for the per-document λ and ν problems, in PyTorch.

Counterpart of multimodalmusig_tpu/ops/solvers.py, which replaced the
reference's per-document NLopt LD_MMA calls (src/MMCTM.jl:127-143, 156-170;
objectives src/common.jl:11-36) with fixed-iteration batched methods:

  * λ: damped Newton whose direction comes from Jacobi-preconditioned CG
    against (Σ⁻¹ + diag(w)), with a branch-free candidate-step line search
    (over-steps 8, 4, 2, then 1 .. 2⁻¹², then 0) and trust-region polish;
  * ν: the objective is separable per coordinate, so a contractive
    fixed-point sweep plus Newton polish, elementwise.

This is the plain path: every dtype on the CPU, float64 on the GPU, and the
oracle that the CUDA kernel (ops/lambda_kernel.py) is held against. All
functions batch over any leading dimensions. For `maximize_lambda` the
documents are the second-to-last axis and μ / Σ⁻¹ carry only the leading
(restart) dimensions: λ (R, D, MK) takes μ (R, MK) and Σ⁻¹ (R, MK, MK), and
λ (B, MK) takes μ (MK,) and Σ⁻¹ (MK, MK).

The budget constants are the JAX package's, measured there (see the
docstrings at multimodalmusig_tpu/ops/solvers.py:62-124);
tests/test_torch_package.py pins them equal.
"""

from __future__ import annotations

import torch

__all__ = [
    "lambda_objective",
    "lambda_grad",
    "maximize_lambda",
    "maximize_nu",
    "NU_LOWER_BOUND",
    "LAMBDA_POLISH_ITERS",
    "NU_FP_ITERS",
    "CG_ITER_F32_CAP",
    "LAMBDA_NITER_F32_CAVI",
    "LAMBDA_POLISH_F32_CAVI",
    "NU_FP_F32_CAVI",
    "CG_F32_CAVI",
]

# Trust region for the unconditional polish steps: scale (never re-direct)
# any step whose |δ|∞ exceeds this — near the optimum a larger one is a
# solver misfire, not progress.
POLISH_MAX_STEP = 2.0
# Cold-start λ polish rounds and ν fixed-point sweeps.
LAMBDA_POLISH_ITERS = 2
NU_FP_ITERS = 8
# Float32 cap on the λ solve's PCG iterations (cg_iter = min(MK, cap);
# float64 keeps the exact cg_iter = MK).
CG_ITER_F32_CAP = 10
# Warm-start budgets of float32 CAVI fits (models/ctm_base.resolved_budgets).
LAMBDA_NITER_F32_CAVI = 3
LAMBDA_POLISH_F32_CAVI = 1
NU_FP_F32_CAVI = 4
CG_F32_CAVI = 4
# Line-search backtracking steps 1, 1/2, ..., 2^-(N_BACKTRACK-1).
N_BACKTRACK = 13
# Exponent clip of the line-search exps (f32 overflow guard).
EXP_CLIP = 60.0
# ν Newton polish rounds after the fixed-point sweeps.
NU_POLISH_ITERS = 4

# reference: src/MMCTM.jl:158 `lower_bounds!(opt, 1e-7)`
NU_LOWER_BOUND = 1e-7


def lambda_objective(lam, nu, Ndivzeta, sumtheta, mu, invSigma):
    """-½(λ-μ)ᵀΣ⁻¹(λ-μ) + λ·sumθ - Σ Ndivζ·exp(λ+ν/2), reduced over the last
    axis; μ broadcasts against λ and `(λ-μ) @ Σ⁻¹` must be a valid matmul."""
    diff = lam - mu
    quad = -0.5 * (diff * (diff @ invSigma)).sum(-1)  # Σ⁻¹ symmetric
    return quad + (lam * sumtheta).sum(-1) - (Ndivzeta * torch.exp(lam + 0.5 * nu)).sum(-1)


def lambda_grad(lam, nu, Ndivzeta, sumtheta, mu, invSigma):
    """∇λ = -Σ⁻¹(λ-μ) + sumθ - Ndivζ·exp(λ+ν/2) (shapes as lambda_objective)."""
    return -((lam - mu) @ invSigma) + sumtheta - Ndivzeta * torch.exp(lam + 0.5 * nu)


def _cg_solve(w, g, invSigma, diag, n_iter: int):
    """Jacobi-preconditioned CG for (Σ⁻¹ + diag(w)) δ = g over (..., D, MK),
    without forming the per-document Hessians: each matvec is one batched
    product with the lane's Σ⁻¹ plus an elementwise term. `diag` is
    diag(Σ⁻¹) broadcast against w. The 1e-30 guards keep an exactly-solved
    (zero-residual) system at δ = x instead of 0/0."""
    M = diag + w  # Jacobi preconditioner (always > 0)
    x = torch.zeros_like(g)
    r = g
    z = r / M
    p = z
    rz = (r * z).sum(-1, keepdim=True)
    for _ in range(n_iter):
        Ap = p @ invSigma + w * p
        alpha = rz / ((p * Ap).sum(-1, keepdim=True) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r / M
        rz_new = (r * z).sum(-1, keepdim=True)
        beta = rz_new / (rz + 1e-30)
        p = z + beta * p
        rz = rz_new
    return x


def maximize_lambda(lam0, nu, Ndivzeta, sumtheta, mu, invSigma, n_iter: int = 7,
                    cg_iter: int = None, polish_iter: int = None):
    """Batched λ solve (replaces NLopt at src/MMCTM.jl:127-143).

    lam0/nu/Ndivzeta/sumtheta: (..., D, MK); mu: (..., MK); invSigma:
    (..., MK, MK) — see the module docstring. `cg_iter` defaults to MK in
    float64 and min(MK, CG_ITER_F32_CAP) otherwise; `polish_iter` to
    LAMBDA_POLISH_ITERS.

    Line-search algebra: for a candidate λ + sδ the quadratic expands as
    -½(q0 + 2s·b + s²·c2) from two matvecs, the linear term as lin0 + s·lind,
    and exp(sδ) comes from one clipped exp per over-step plus a sqrt chain
    for s ≤ 1, so no candidate needs a matvec of its own. The argmax over
    candidates (s = 0 included) keeps every document's iterate monotone.
    """
    MK = lam0.shape[-1]
    if cg_iter is None:
        cg_iter = MK if lam0.dtype == torch.float64 else min(MK, CG_ITER_F32_CAP)
    if polish_iter is None:
        polish_iter = LAMBDA_POLISH_ITERS
    mu = mu.unsqueeze(-2)
    diag = torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2)

    lam = lam0
    for _ in range(n_iter):
        w = Ndivzeta * torch.exp(lam + 0.5 * nu)
        diff = lam - mu
        Sdiff = diff @ invSigma
        delta = _cg_solve(w, -Sdiff + sumtheta - w, invSigma, diag, cg_iter)
        Sdelta = delta @ invSigma
        q0 = (diff * Sdiff).sum(-1)
        b = (delta * Sdiff).sum(-1)
        c2 = (delta * Sdelta).sum(-1)
        lin0 = (lam * sumtheta).sum(-1)
        lind = (delta * sumtheta).sum(-1)
        best_f = -0.5 * q0 + lin0 - w.sum(-1)  # s = 0: stay put
        best_s = torch.zeros_like(best_f)

        def consider(s, e_s, best_f, best_s):
            f = -0.5 * (q0 + 2.0 * s * b + s * s * c2) + lin0 + s * lind - (w * e_s).sum(-1)
            ok = torch.isfinite(f) & (f > best_f)
            return torch.where(ok, f, best_f), torch.where(ok, s, best_s)

        # the over-steps get their own clipped exp: a squaring chain from
        # exp(δ) overflows f32 once δ > ~11, and w·inf = NaN on w = 0
        # coordinates (empty doc × modality blocks) would reject them
        for s in (8.0, 4.0, 2.0):
            best_f, best_s = consider(
                s, torch.exp(torch.clamp(s * delta, max=EXP_CLIP)), best_f, best_s
            )
        e_s = torch.exp(torch.clamp(delta, max=EXP_CLIP))
        s = 1.0
        for _ in range(N_BACKTRACK):
            best_f, best_s = consider(s, e_s, best_f, best_s)
            e_s = torch.sqrt(e_s)
            s = s / 2.0
        lam = lam + best_s.unsqueeze(-1) * delta

    for _ in range(polish_iter):
        w = Ndivzeta * torch.exp(lam + 0.5 * nu)
        g = -((lam - mu) @ invSigma) + sumtheta - w
        delta = _cg_solve(w, g, invSigma, diag, cg_iter)
        dmax = delta.abs().amax(-1, keepdim=True)
        delta = delta * torch.clamp(POLISH_MAX_STEP / torch.clamp(dmax, min=1e-30), max=1.0)
        step = lam + delta
        lam = torch.where(torch.isfinite(step).all(-1, keepdim=True), step, lam)
    return lam


def maximize_nu(nu0, lam, Ndivzeta, invSigma_diag, n_iter: int = NU_FP_ITERS):
    """Elementwise ν maximization; all arguments broadcast.

    Replaces the MK-dimensional NLopt solve at src/MMCTM.jl:156-170. The
    stationarity condition -a - (b/2)e^{ν/2} + 1/(2ν) = 0 (a = ½Σ⁻¹ᵢᵢ,
    b = Ndivζ·e^λ) is the fixed point ν = 1/(2a + b·e^{ν/2}), a contraction
    near the root; `n_iter` sweeps land in the quadratic basin and
    NU_POLISH_ITERS Newton steps polish to machine precision. ν ≥ 1e-7 is a
    clip (src/MMCTM.jl:158).
    """
    a = 0.5 * invSigma_diag
    b = Ndivzeta * torch.exp(lam)
    pos = b > 0

    def wexp(nu):
        # b·e^{ν/2} with an overflow guard, exactly 0 where b == 0 (N = 0)
        return torch.where(pos, b * torch.exp(torch.clamp(0.5 * nu, max=EXP_CLIP)), 0.0)

    shape = torch.broadcast_shapes(nu0.shape, lam.shape, Ndivzeta.shape, invSigma_diag.shape)
    nu = nu0.expand(shape)
    for _ in range(n_iter):
        nu = torch.clamp(1.0 / (2.0 * a + wexp(nu)), min=NU_LOWER_BOUND)
    for _ in range(NU_POLISH_ITERS):
        w = wexp(nu)
        g = -a - 0.5 * w + 0.5 / nu
        hess = -0.25 * w - 0.5 / (nu * nu)  # always < 0
        step = torch.clamp(nu - g / hess, min=NU_LOWER_BOUND)
        nu = torch.where(torch.isfinite(step), step, nu)
    return nu
