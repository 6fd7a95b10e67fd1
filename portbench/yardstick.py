"""The benchmark's frozen counts of operations and bytes, and the card's peaks.

`solve_flops`, `bound`, `eta_bound` and `theta_bound` are copies of the
functions of the same names in the repository's chip_smoke.py, kept here
so that a later change to the program cannot change the yardstick. Peaks
are NVIDIA's published H100 SXM figures at 700 W: float32 outside the
tensor cores, and HBM3 bandwidth.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def solve_flops(MK, n_iter, cg_iter, polish_iter):
    """Float operations of one (restart, document) λ solve, each add,
    multiply, divide, exp and sqrt counted once: a matvec 2·MK², a PCG
    iteration a matvec and 12·MK plus 4·MK to start; a Newton step 2
    matvecs, a PCG, 6 dot products and 16 line-search candidates of 4·MK; a
    polish step a matvec, a PCG, 3 dot products or maxima and 6·MK."""
    mv = 2 * MK * MK
    pcg = cg_iter * (mv + 12 * MK) + 4 * MK
    newton = 2 * mv + pcg + 6 * 2 * MK + 16 * 4 * MK
    polish = mv + pcg + 3 * 2 * MK + 6 * MK
    return n_iter * newton + polish_iter * polish


def bound(n_bytes, flops):
    """(ms, "bytes" or "operations"): the least time of the card for this
    work, at its published memory rate and float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def eta_flops(R, D, K, n_iter, cg_iter, polish_iter, nu_n_iter, lam_prev=False):
    """Operations of one η kernel call: per problem the λ solve, and ζ and
    N/ζ 4·MK, the ν setup 3·MK, each fixed-point sweep 7·MK, each of the 4
    Newton steps 16·MK, the secant start 5·MK with `lam_prev`."""
    MK = sum(K)
    nu = (4 + 3 + 7 * nu_n_iter + 4 * 16 + (5 if lam_prev else 0)) * MK
    return R * D * (solve_flops(MK, n_iter, cg_iter, polish_iter) + nu)


def eta_bound(R, D, K, n_iter, cg_iter, polish_iter, nu_n_iter, lam_prev=False):
    """The η kernel: reads λ, ν, sumθ (R, D, MK), N (D, M), μ and Σ⁻¹ once
    and writes ζ (R, D, M), ν and λ (R, D, MK); operations `eta_flops`."""
    MK, M = sum(K), len(K)
    n_bytes = 4 * ((6 if lam_prev else 5) * R * D * MK + D * M + R * MK + R * MK * MK
                   + R * D * M)
    return bound(n_bytes, eta_flops(R, D, K, n_iter, cg_iter, polish_iter, nu_n_iter, lam_prev))


def theta_flops(R, D, V, K):
    """Operations of one θ kernel call (one modality): per (r, d, v) cell
    three K-wide contractions of 2·K operations and one division, and per λ
    and logw entry a subtraction of the max and an exp."""
    return R * (6 * D * V * K + D * V + 2 * (D * K + V * K))


def theta_bound(R, D, V, K):
    """The θ kernel, per modality: reads λ's block (R, D, K), logw (R, V, K)
    and X (D, V) once and writes sumθ (R, D, K) and the scatter (R, K, V)."""
    n_bytes = 4 * (2 * R * D * K + 2 * R * V * K + D * V)
    return bound(n_bytes, theta_flops(R, D, V, K))


# The inner-solver budgets of a float32 CAVI step when the benchmark was
# written (the port's ctm_base.resolved_budgets: Newton 3, PCG 4, polish 1,
# ν sweeps 4): the work a step is credited with, whatever a later program
# runs.
STEP_BUDGETS = {"n_iter": 3, "cg_iter": 4, "polish_iter": 1, "nu_n_iter": 4}


def step_flops_per_lane(D, K, V, budgets=STEP_BUDGETS):
    """Operations of one CAVI step of one restart lane: the η kernel and
    one θ kernel per modality at `budgets` ({"n_iter", "cg_iter",
    "polish_iter", "nu_n_iter"}), plus the products
    counted from shapes: μ (D·MK) and Σ's scatter (2·D·MK² and D·MK for the
    differences), γ = α + scatter (K·V a modality), and the lls: the
    mixture product 2·D·K·V, the log and the count-weighting 2·D·V a
    modality."""
    MK = sum(K)
    ops = eta_flops(1, D, K, **budgets)
    ops += sum(theta_flops(1, D, v, k) for v, k in zip(V, K))
    ops += D * MK + 2 * D * MK * MK + D * MK
    ops += sum(k * v + 2 * D * k * v + 2 * D * v for v, k in zip(V, K))
    return ops
