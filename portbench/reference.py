"""Plain reference of one MMCTM CAVI step and of the quantities a fit reports.

Written from the model's equations (the reference Julia package's
src/MMCTM.jl and src/common.jl), in plain PyTorch, for any dtype and
device. It imports nothing of the package under test. Where the program
runs inner solvers with fixed budgets, the reference solves each problem
to convergence, so it does not follow the program's branch decisions:
  * ν, per coordinate, by bisection on the stationarity condition;
  * λ, per document, by Newton with an exact Cholesky direction and a
    halving line search, to convergence.
θ is materialized (softmax over the topics of every (document, item)
cell), as the model defines it.

Every product (`mm`, `einsum`) runs in full precision, or inside
`tf32_products()` as TF32 does it: each float32 operand rounded to TF32's
10-bit mantissa, the sums in float32. The reference runs in float64; the
control, one precision below the program's float32 with TF32 off, in
float32 inside `tf32_products()`.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

NU_LOWER_BOUND = 1e-7  # src/MMCTM.jl:158 `lower_bounds!(opt, 1e-7)`

_TF32 = contextvars.ContextVar("portbench_tf32_products", default=False)


@contextlib.contextmanager
def tf32_products():
    """Round the float32 operands of every product of the block to TF32."""
    token = _TF32.set(True)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        _TF32.reset(token)


def to_tf32(x):
    """float32 `x` rounded to the nearest TF32 value (10 mantissa bits, ties
    away from zero, as cvt.rna.tf32 does); any other dtype unchanged."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a, b):
    if _TF32.get():
        a, b = to_tf32(a), to_tf32(b)
    return a @ b


def einsum(eq, *ops):
    if _TF32.get():
        ops = [to_tf32(o) for o in ops]
    return torch.einsum(eq, *ops)


def offsets(K):
    out, acc = [], 0
    for k in K:
        out.append(acc)
        acc += k
    return out


def blocks(t, K):
    """The per-modality topic blocks of the last axis."""
    return [t[..., o:o + k] for o, k in zip(offsets(K), K)]


def xlogy(x, y):
    """x·log(y) with 0·log(anything) = 0."""
    nz = x != 0
    return torch.where(nz, x * torch.log(torch.where(nz, y, torch.ones_like(y))),
                       torch.zeros_like(y))


def proportions(lam, K):
    """Per-modality softmax of λ's blocks: list of (..., D, K_m)."""
    return [torch.softmax(b, dim=-1) for b in blocks(lam, K)]


def signatures(gamma):
    """ϕ = γ normalized over the vocabulary: list of (..., K_m, V_m)."""
    return [g / g.sum(dim=-1, keepdim=True) for g in gamma]


def modality_lls(X, props, phi):
    """(R, M): Σ_d Σ_v X·log(Σ_k props·ϕ) / Σ X per modality
    (src/MMCTM.jl:384-448)."""
    return torch.stack([xlogy(Xm, mm(p, f)).sum(dim=(-2, -1)) / Xm.sum()
                        for Xm, p, f in zip(X, props, phi)], dim=-1)


def lls_of_states(lam, gamma, X, K, lanes_per_block=50):
    """(R, M) lls of every lane of (λ (R, D, MK), γ list of (R, K_m, V_m)),
    in blocks of lanes so that (lanes, D, V) fits."""
    out = []
    for s in range(0, lam.shape[0], lanes_per_block):
        sl = slice(s, s + lanes_per_block)
        out.append(modality_lls(X, proportions(lam[sl], K), signatures([g[sl] for g in gamma])))
    return torch.cat(out, dim=0)


def theta_moments(lam, logw, X, K):
    """sumθ (R, D, MK) and the scatters [(R, K_m, V_m)] of θ[r,d,v,:] =
    softmax_k(λ_block[r,d,k] + logw_m[r,v,k]) (src/MMCTM.jl:110-117,
    183-198, 224-250)."""
    sums, scatters = [], []
    for Xm, lb, lw in zip(X, blocks(lam, K), logw):
        theta = torch.softmax(lb[:, :, None, :] + lw[:, None, :, :], dim=-1)  # (R, D, V, K)
        sums.append(einsum("dv,rdvk->rdk", Xm, theta))
        scatters.append(einsum("dv,rdvk->rkv", Xm, theta))
    return torch.cat(sums, dim=-1), scatters


def zeta_of(lam, nu, K):
    """ζ_dm = Σ_k exp(λ + ν/2) over modality m's block (src/MMCTM.jl:172-181)."""
    return torch.stack([b.sum(dim=-1) for b in blocks(torch.exp(lam + 0.5 * nu), K)], dim=-1)


def expand_blocks(t, K):
    """(R, D, M) -> (R, D, MK), each modality's value over its block."""
    return torch.cat([t[..., m:m + 1].expand(*t.shape[:-1], k) for m, k in enumerate(K)], dim=-1)


def solve_nu(lam, Ndivzeta, invSigma_diag, n_bisect=200):
    """argmax_ν -½νΣ⁻¹ᵢᵢ - Ndivζ·exp(λ+ν/2) + ½log ν per coordinate
    (src/common.jl:25-36), ν ≥ 1e-7: the root of the decreasing derivative
    -a - (b/2)e^{ν/2} + 1/(2ν), a = ½Σ⁻¹ᵢᵢ, b = Ndivζ·e^λ, bracketed by
    [1e-7, 1/(2a)] and bisected."""
    a = (0.5 * invSigma_diag).expand_as(lam)
    b = Ndivzeta * torch.exp(lam)
    lo = torch.full_like(lam, NU_LOWER_BOUND)
    hi = 1.0 / (2.0 * a)

    def deriv(nu):
        return -a - 0.5 * b * torch.exp(0.5 * nu) + 0.5 / nu

    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        up = deriv(mid) > 0
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    return torch.where(deriv(torch.full_like(lam, NU_LOWER_BOUND)) <= 0,
                       torch.full_like(lam, NU_LOWER_BOUND), 0.5 * (lo + hi))


def lambda_objective(lam, nu, Ndivzeta, sumtheta, mu, invSigma):
    """-½(λ-μ)ᵀΣ⁻¹(λ-μ) + λ·sumθ - Σ Ndivζ·exp(λ+ν/2) (src/common.jl:11-23)."""
    diff = lam - mu[:, None, :]
    return (-0.5 * (diff * mm(diff, invSigma)).sum(-1) + (lam * sumtheta).sum(-1)
            - (Ndivzeta * torch.exp(lam + 0.5 * nu)).sum(-1))


def solve_lambda(lam0, nu, Ndivzeta, sumtheta, mu, invSigma, n_newton=60, n_halve=40):
    """argmax_λ of `lambda_objective` for every (lane, document): Newton
    with the exact direction H⁻¹g, H = Σ⁻¹ + diag(Ndivζ·exp(λ+ν/2)), and
    the largest step of 1, ½, ¼, ... that does not lower the objective
    (the full step once it is below 1e-6)."""
    lam = lam0
    for _ in range(n_newton):
        w = Ndivzeta * torch.exp(lam + 0.5 * nu)
        g = -mm(lam - mu[:, None, :], invSigma) + sumtheta - w
        H = invSigma[:, None, :, :] + torch.diag_embed(w)
        L, _ = torch.linalg.cholesky_ex(H)
        delta = torch.cholesky_solve(g.unsqueeze(-1), L).squeeze(-1)
        f0 = lambda_objective(lam, nu, Ndivzeta, sumtheta, mu, invSigma)
        step = torch.ones_like(f0)
        # a full step below 1e-6 is taken as it is: there the objective's
        # change is below its rounding, and Newton converges quadratically
        accepted = delta.abs().amax(dim=-1) < 1e-6
        for _ in range(n_halve):
            f = lambda_objective(lam + step[..., None] * delta, nu, Ndivzeta, sumtheta, mu,
                                 invSigma)
            accepted = accepted | (torch.isfinite(f) & (f >= f0))
            if bool(accepted.all()):
                break
            step = torch.where(accepted, step, 0.5 * step)
        move = torch.where(accepted, step, torch.zeros_like(step))[..., None] * delta
        lam = lam + move
        if not bool((move.abs() > 1e-15 * (1.0 + lam.abs())).any()):
            break
    return lam


def cavi_step(inp, X, K):
    """One CAVI iteration (src/MMCTM.jl:463-479) of every lane of `inp`
    ({lam, nu, mu, invSigma (R, ...), Elnphi list of (R, K_m, V_m), alpha
    (R, M)}): the E-step from the incoming λ and E[ln ϕ] (θ moments, then ζ
    and N/ζ from the incoming λ and ν, the ν solve from the incoming λ, the
    λ solve from the incoming λ with the new ν), then μ, Σ, γ = α +
    scatter, E[ln ϕ], and the lls of the new λ and γ. Returns a dict of
    the new fields and the two θ moments."""
    lam, nu, mu, invSigma = inp["lam"], inp["nu"], inp["mu"], inp["invSigma"]
    D = lam.shape[1]
    logw = [e.mT for e in inp["Elnphi"]]
    sumtheta, scatter = theta_moments(lam, logw, X, K)
    N = torch.stack([Xm.sum(dim=1) for Xm in X], dim=-1)  # (D, M)
    zeta = zeta_of(lam, nu, K)
    Ndivzeta = expand_blocks(N / zeta, K)
    diag = torch.diagonal(invSigma, dim1=-2, dim2=-1)[:, None, :]
    nu_new = solve_nu(lam, Ndivzeta, diag)
    lam_new = solve_lambda(lam, nu_new, Ndivzeta, sumtheta, mu, invSigma)
    mu_new = lam_new.mean(dim=1)
    E = lam_new - mu_new[:, None, :]
    Sigma = (torch.diag_embed(nu_new.sum(dim=1)) + mm(E.mT, E)) / D
    gamma = [inp["alpha"][:, m, None, None] + s for m, s in enumerate(scatter)]
    Elnphi = [torch.special.digamma(g) - torch.special.digamma(g.sum(dim=-1, keepdim=True))
              for g in gamma]
    ll = modality_lls(X, proportions(lam_new, K), signatures(gamma))
    return {"sumtheta": sumtheta, "scatter": scatter, "zeta": zeta, "nu": nu_new,
            "lam": lam_new, "mu": mu_new, "Sigma": Sigma, "gamma": gamma, "Elnphi": Elnphi,
            "ll": ll}
