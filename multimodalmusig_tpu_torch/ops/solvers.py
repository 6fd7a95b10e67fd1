"""Batched maximizers for the per-document λ and ν problems, in PyTorch.

Counterpart of multimodalmusig_tpu/ops/solvers.py, which replaced the
reference's per-document NLopt LD_MMA calls (src/MMCTM.jl:127-143, 156-170;
objectives src/common.jl:11-36) with fixed-iteration batched methods:

  * λ: damped Newton whose direction comes from Jacobi-preconditioned CG
    against (Σ⁻¹ + diag(w)) ("pcg", the default) or from a direct Cholesky
    solve of it ("chol", CTMBaseConfig.lambda_solver), with a branch-free
    candidate-step line search (over-steps 8, 4, 2, then 1 .. 2⁻¹², then 0)
    and trust-region polish;
  * ν: the objective is separable per coordinate, so a contractive
    fixed-point sweep plus Newton polish, elementwise;
  * α (autoα, src/MMCTM.jl:252-269): Newton on log α with the same
    candidate-step search, then Newton polish in α-space.

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
    "extrapolated_start",
    "nu_objective",
    "nu_objective_terms",
    "nu_grad",
    "maximize_nu",
    "alpha_objective",
    "alpha_grad",
    "maximize_alpha",
    "NU_LOWER_BOUND",
    "ALPHA_LOWER_BOUND",
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
# Per-coordinate bound of the secant warm start's step (`extrapolated_start`),
# the JAX package's clip (multimodalmusig_tpu/models/ctm_base.py:408): a
# large early swing cannot overflow exp(λ) in the solver's first gradient.
EXTRAP_CLIP = 4.0
# Pivot floor of the direct Cholesky λ direction (`_chol_solve`), the JAX
# package's _CHOL_PIVOT_FLOOR.
CHOL_PIVOT_FLOOR = 1e-30

# reference: src/MMCTM.jl:158 and :254 `lower_bounds!(opt, 1e-7)`
NU_LOWER_BOUND = 1e-7
ALPHA_LOWER_BOUND = 1e-7


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


def _chol_solve(w, g, invSigma):
    """(Σ⁻¹ + diag(w)) δ = g by a direct Cholesky solve, as the JAX
    package's _chol_solve (multimodalmusig_tpu/ops/solvers.py:271-330): the
    factor L column by column, each column one vector operation over the
    problems (the JAX order of subtractions), every pivot floored at
    CHOL_PIVOT_FLOOR, then the forward and back substitutions by
    `torch.linalg.solve_triangular`. w and g are (..., D, MK) and Σ⁻¹
    (..., MK, MK), as in `maximize_lambda`. The floor makes a pivot that
    f32 cancellation drove to or below 0 a huge but finite direction,
    which the line search rejects; the Newton body (unlike the polish)
    does not guard a non-finite direction, as in the JAX package."""
    n = g.shape[-1]
    idx = torch.arange(n, device=g.device)
    cols = []  # cols[j]: (..., D, n) column j of L, zero above the diagonal
    for j in range(n):
        r = invSigma[..., None, :, j] + torch.where(idx == j, w[..., j:j + 1], 0.0)
        for k in range(j):
            r = r - cols[k] * cols[k][..., j:j + 1]
        d = torch.sqrt(torch.clamp(r[..., j], min=CHOL_PIVOT_FLOOR))
        cols.append(torch.where(idx >= j, r / d[..., None], 0.0))
    L = torch.stack(cols, dim=-1)
    y = torch.linalg.solve_triangular(L, g.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)


def maximize_lambda(lam0, nu, Ndivzeta, sumtheta, mu, invSigma, n_iter: int = 7,
                    cg_iter: int = None, polish_iter: int = None, solver: str = "pcg"):
    """Batched λ solve (replaces NLopt at src/MMCTM.jl:127-143).

    lam0/nu/Ndivzeta/sumtheta: (..., D, MK); mu: (..., MK); invSigma:
    (..., MK, MK) — see the module docstring. `cg_iter` defaults to MK in
    float64 and min(MK, CG_ITER_F32_CAP) otherwise; `polish_iter` to
    LAMBDA_POLISH_ITERS. `solver` picks the Newton direction of both the
    Newton steps and the polish: "pcg" (`_cg_solve`, `cg_iter` iterations)
    or "chol" (`_chol_solve`, which reads no `cg_iter`); any other name
    raises ValueError.

    Line-search algebra: for a candidate λ + sδ the quadratic expands as
    -½(q0 + 2s·b + s²·c2) from two matvecs, the linear term as lin0 + s·lind,
    and exp(sδ) comes from one clipped exp per over-step plus a sqrt chain
    for s ≤ 1, so no candidate needs a matvec of its own. The argmax over
    candidates (s = 0 included) keeps every document's iterate monotone.
    """
    MK = lam0.shape[-1]
    if solver not in ("pcg", "chol"):
        raise ValueError(f"solver must be 'pcg' or 'chol', got {solver!r}")
    if cg_iter is None:
        cg_iter = MK if lam0.dtype == torch.float64 else min(MK, CG_ITER_F32_CAP)
    if polish_iter is None:
        polish_iter = LAMBDA_POLISH_ITERS
    mu = mu.unsqueeze(-2)
    diag = torch.diagonal(invSigma, dim1=-2, dim2=-1).unsqueeze(-2)

    def newton_dir(w, g):
        if solver == "chol":
            return _chol_solve(w, g, invSigma)
        return _cg_solve(w, g, invSigma, diag, cg_iter)

    lam = lam0
    for _ in range(n_iter):
        w = Ndivzeta * torch.exp(lam + 0.5 * nu)
        diff = lam - mu
        Sdiff = diff @ invSigma
        delta = newton_dir(w, -Sdiff + sumtheta - w)
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
        delta = newton_dir(w, g)
        dmax = delta.abs().amax(-1, keepdim=True)
        delta = delta * torch.clamp(POLISH_MAX_STEP / torch.clamp(dmax, min=1e-30), max=1.0)
        step = lam + delta
        lam = torch.where(torch.isfinite(step).all(-1, keepdim=True), step, lam)
    return lam


def extrapolated_start(lam, lam_prev, extrap):
    """The start of a fit loop's λ solve: λ itself (the same tensor) unless
    `extrap` is set (not None or 0) and `lam_prev` (the previous iteration's
    λ) is given, then the secant step λ + clamp(c·(λ − λ_prev), ±EXTRAP_CLIP)
    with c = `extrap` (CTMBaseConfig.lambda_extrap; the JAX package's
    solve_eta, multimodalmusig_tpu/models/ctm_base.py:405-408). Clamps
    propagate NaN, so a dead lane stays dead."""
    if not extrap or lam_prev is None:
        return lam
    return lam + torch.clamp(float(extrap) * (lam - lam_prev), -EXTRAP_CLIP, EXTRAP_CLIP)


def nu_objective(nu, lam, Ndivzeta, invSigma_diag):
    """-½Σνᵢ·Σ⁻¹ᵢᵢ - Σ Ndivζ·exp(λ+ν/2) + ½Σ log ν (src/common.jl:25-36),
    reduced over the last axis; `invSigma_diag` is diag(Σ⁻¹), the only part
    of Σ⁻¹ the trace term touches, which makes the problem separable."""
    return nu_objective_terms(nu, lam, Ndivzeta, invSigma_diag).sum(-1)


def nu_objective_terms(nu, lam, Ndivzeta, invSigma_diag):
    """The per-coordinate terms of `nu_objective`, before the sum."""
    return -0.5 * nu * invSigma_diag - Ndivzeta * torch.exp(lam + 0.5 * nu) + 0.5 * torch.log(nu)


def nu_grad(nu, lam, Ndivzeta, invSigma_diag):
    """∂/∂νᵢ = -½Σ⁻¹ᵢᵢ - (Ndivζᵢ/2)·exp(λᵢ+νᵢ/2) + 1/(2νᵢ)."""
    return -0.5 * invSigma_diag - 0.5 * Ndivzeta * torch.exp(lam + 0.5 * nu) + 0.5 / nu


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


# ---------------------------------------------------------------------------
# α objective (src/common.jl:38-46): the symmetric Dirichlet MLE
# ---------------------------------------------------------------------------


def alpha_objective(alpha, sum_Elnphi, K, V):
    """K·(lgamma(Vα) - V·lgamma(α)) + α·ΣElnϕ (src/common.jl:38-46)."""
    return K * (torch.lgamma(V * alpha) - V * torch.lgamma(alpha)) + alpha * sum_Elnphi


def alpha_grad(alpha, sum_Elnphi, K, V):
    """K·V·(digamma(Vα) - digamma(α)) + ΣElnϕ."""
    return K * V * (torch.digamma(V * alpha) - torch.digamma(alpha)) + sum_Elnphi


def _alpha_hess(alpha, K, V):
    """d²/dα² of the objective: K·V²·ψ₁(Vα) - K·V·ψ₁(α)."""
    return (K * V * V * torch.special.polygamma(1, V * alpha)
            - K * V * torch.special.polygamma(1, alpha))


def maximize_alpha(alpha0, sum_Elnphi, K: int, V: int, n_iter: int = 30):
    """Newton for the symmetric Dirichlet hyperparameter MLE, elementwise
    over any batch shape (one α per restart lane): replaces the 1-dim NLopt
    solve of src/MMCTM.jl:252-269 / src/IMMCTM.jl:225-244, as the JAX
    package's maximize_alpha does.

    Newton runs on u = log α, so α ≥ ALPHA_LOWER_BOUND (src/MMCTM.jl:254)
    holds by construction. Each step takes the best of the candidates
    u + s·δ over the line-search scales (over-steps 8, 4, 2, then 1 ..
    2^-(N_BACKTRACK-1), then 0: the first of equal values wins), with δ the
    log-space Newton step where that Hessian is negative and sign(g) where
    it is not; then NU_POLISH_ITERS Newton steps in α-space, where the
    objective is concave. No branch reads the data on the host."""
    # made on the device: a copy from the host would sync
    kw = dict(dtype=alpha0.dtype, device=alpha0.device)
    scales = torch.cat([2.0 ** torch.arange(3, 0, -1, **kw), 2.0 ** -torch.arange(N_BACKTRACK, **kw),
                        torch.zeros(1, **kw)])
    u = torch.log(torch.clamp(alpha0, min=ALPHA_LOWER_BOUND))
    S = sum_Elnphi.unsqueeze(-1)
    for _ in range(n_iter):
        a = torch.exp(u)
        g_a = alpha_grad(a, sum_Elnphi, K, V)
        g_u = g_a * a
        h_u = _alpha_hess(a, K, V) * a * a + g_a * a
        delta = torch.where(h_u < 0, -g_u / h_u, torch.sign(g_u))
        cand = u.unsqueeze(-1) + scales * delta.unsqueeze(-1)
        f = alpha_objective(torch.exp(cand), S, K, V)
        f = torch.where(torch.isfinite(f), f, -torch.inf)
        u = torch.gather(cand, -1, f.argmax(dim=-1, keepdim=True)).squeeze(-1)
    for _ in range(NU_POLISH_ITERS):
        a = torch.exp(u)
        g_a = alpha_grad(a, sum_Elnphi, K, V)
        h_a = _alpha_hess(a, K, V)
        step = torch.where(h_a < 0, torch.log(torch.clamp(a - g_a / h_a, min=ALPHA_LOWER_BOUND)), u)
        u = torch.where(torch.isfinite(step), step, u)
    return torch.clamp(torch.exp(u), min=ALPHA_LOWER_BOUND)
