#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodalmusig_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles both kernels with nvcc for sm_90a, one nvcc process
     each, started together: the λ Newton/PCG solve (csrc/lambda_newton.cu)
     and the θ moments (csrc/theta_moments.cu); prints the build times and
     ptxas reports;
  3. λ kernel against its plain PyTorch version, both on the card, on seeded
     SPD problems: the main path's shape (100, 560, 14) with the f32 CAVI
     budgets (warm start) and the cold defaults, MK = 40 and 128 at
     (100, 560) with the CAVI budgets, and ragged D at MK = 19, 40 and 128
     with the cold defaults; prints both times (median of 20 CUDA-event
     timings) at each (100, 560) shape;
  4. θ kernel against its plain PyTorch version at the BRCA shapes
     (100, 560, 96, 7) and (100, 560, 48, 7) and at the ragged
     (3, 33, 128, 11) and (2, 8, 5, 2), with bit-identical repeat launches;
     prints both times at the BRCA shapes;
  5. main path: the best-of-100 MMCTM K=(7, 7), α=0.1 restart fit on the
     bundled BRCA-EU SNV+SV counts (D=560), float32, tol 1e-5, maxiter 1000,
     through `fit_restarts(..., device="cuda")`, once warm and once timed;
     checks that it went through both kernels, that at least 99 lanes are
     finite and that the best ll per modality is within 5e-3 of the JAX
     package's value; a short fit on the card is also held against the same
     fit in float64 on the CPU;
  6. single model: `MMCTM([7, 7], [0.1, 0.1], X, device="cuda").fit(maxiter=30)`,
     the λ kernel's R = 1 entry;
  7. IMMCTM path: `fit_immctm_restarts([7, 7], [0.1, 0.1], features, X,
     restarts=100, maxiter=1000, tol=1e-5, device="cuda")` on the same
     counts, with the SNV terms factored into substitution × context and the
     SV terms into type × size/region (tools/families_bench.py:66-77), once
     warm and once timed, with the gates of phase 5 against the JAX
     package's IMMCTM value, and its own short card-vs-CPU check.
The last two lines of standard output are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

SEED = 147959412
RESTARTS = 100
TOL = 1e-5
MAXITER = 1000
KERNEL_ATOL = 5e-5
STATIONARITY_TOL = 1e-2
THETA_RTOL, THETA_ATOL = 2e-5, 1e-4
LL_SLACK = 5e-3
# Best finite ll per modality of the JAX package's best-of-16 fit of the same
# workload on the CPU, float32 (16/16 lanes finite):
#   fit_restarts(jax.random.key(147959412), X,
#                MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=jnp.float32),
#                jnp.asarray([0.1, 0.1], jnp.float32), restarts=16,
#                maxiter=1000, tol=1e-5)   # multimodalmusig_tpu.parallel.restarts
JAX_CPU_BEST_LL = (-3.93717622756958, -3.035710334777832)
# The same for IMMCTM with the features of `brca_features` (16/16 finite):
#   model = IMMCTM([7, 7], [0.1, 0.1], [feats_snv, feats_sv], docs, dtype=jnp.float32)
#   _immctm_restarts_from_keys(jax.random.split(jax.random.key(147959412), 16),
#       model.Xdense, model.F, model.state.alpha, config=model.config,
#       maxiter=1000, tol=1e-5)   # the runner of fit_immctm_restarts
JAX_CPU_BEST_IMMCTM_LL = (-3.955171585083008, -3.0439767837524414)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of `fn()` by CUDA events, one event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def spd_problem(gen, R, D, MK, device):
    """Seeded λ problems as in tests/test_pallas_kernels.py: well-posed SPD
    Σ⁻¹ = I + 0.05·AAᵀ/MK per lane, counts-scale Ndivζ and sumθ."""
    import torch

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, dtype=torch.float64)

    A = torch.randn(R, MK, MK, generator=gen, dtype=torch.float64)
    invS = torch.eye(MK, dtype=torch.float64) + 0.05 * (A @ A.mT) / MK
    args = (
        torch.zeros(R, D, MK, dtype=torch.float64),
        u(0.5, 1.5, R, D, MK),
        u(1.0, 10.0, R, D, MK),
        u(0.0, 5.0, R, D, MK),
        torch.randn(R, MK, generator=gen, dtype=torch.float64),
        invS,
    )
    return [a.to(device=device, dtype=torch.float32) for a in args]


def lambda_phase(lk):
    import torch
    from multimodalmusig_tpu_torch.ops.solvers import (
        CG_F32_CAVI, LAMBDA_NITER_F32_CAVI, LAMBDA_POLISH_F32_CAVI, lambda_grad,
    )

    cavi = dict(n_iter=LAMBDA_NITER_F32_CAVI, cg_iter=CG_F32_CAVI,
                polish_iter=LAMBDA_POLISH_F32_CAVI)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    timings = {}
    for label, (R, D, MK), budgets, warm in (
        ("main-path shape, f32 CAVI budgets, warm start", (RESTARTS, 560, 14), cavi, True),
        ("main-path shape, cold defaults", (RESTARTS, 560, 14), {}, False),
        ("ragged D=33, MK=19, cold defaults", (3, 33, 19), {}, False),
        ("MK=40, f32 CAVI budgets, warm start", (RESTARTS, 560, 40), cavi, True),
        ("ragged D=37, MK=40, cold defaults", (3, 37, 40), {}, False),
        ("MK=128, f32 CAVI budgets, warm start", (RESTARTS, 560, 128), cavi, True),
        ("ragged D=29, MK=128, cold defaults", (3, 29, 128), {}, False),
    ):
        lam0, nu, ndz, st, mu, invS = spd_problem(gen, R, D, MK, "cuda")
        if warm:
            # a CAVI-like warm start: near the optimum of the previous iterate
            opt = lk.maximize_lambda_restarts_plain(lam0, nu, ndz, st, mu, invS)
            noise = torch.randn(R, D, MK, generator=gen, dtype=torch.float64)
            lam0 = opt + 0.05 * noise.to(device="cuda", dtype=torch.float32)
        args = (lam0, nu, ndz, st, mu, invS)
        got = lk.maximize_lambda_restarts(*args, **budgets)
        want = lk.maximize_lambda_restarts_plain(*args, **budgets)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        g = lambda_grad(got, nu, ndz, st, mu.unsqueeze(-2), invS)
        gmax = float(g.abs().max())
        print(f"λ kernel vs plain [{label}] (R, D, MK)=({R}, {D}, {MK}): "
              f"max|kernel - plain| = {err:.3e}, max|grad| at kernel result = {gmax:.3e}")
        if not torch.isfinite(got).all():
            fail(f"λ kernel result not finite [{label}]")
        if err > KERNEL_ATOL:
            fail(f"λ kernel disagrees with its plain version by {err:.3e} > {KERNEL_ATOL} [{label}]")
        if gmax > STATIONARITY_TOL:
            fail(f"λ kernel result not stationary: |g| = {gmax:.3e} [{label}]")
        max_err = max(max_err, err)
        if warm:
            ms = cuda_ms(lambda: lk.maximize_lambda_restarts(*args, **budgets))
            plain_ms = cuda_ms(lambda: lk.maximize_lambda_restarts_plain(*args, **budgets))
            timings[MK] = (ms, plain_ms)
            print(f"λ time at ({R}, {D}, {MK}), f32 CAVI budgets: kernel {ms:.4f} ms, "
                  f"plain PyTorch {plain_ms:.4f} ms (median of 20 CUDA-event timings)")
    return max_err, timings[14]


def theta_phase(tk):
    import torch

    gen = torch.Generator().manual_seed(1)
    max_err = 0.0
    timings = {}
    for R, D, V, K in ((RESTARTS, 560, 96, 7), (RESTARTS, 560, 48, 7), (3, 33, 128, 11),
                       (2, 8, 5, 2)):
        # the inputs of tests/test_pallas_kernels.py, per restart lane
        lam = 2.0 * torch.randn(R, D, K, generator=gen)
        logw = torch.randn(R, V, K, generator=gen) - 4.0
        X = torch.randint(0, 30, (D, V), generator=gen).float()
        args = [t.to("cuda") for t in (lam, logw, X)]
        got = tk.theta_moments_fused(*args)
        again = tk.theta_moments_fused(*args)
        want = tk.theta_moments_fused_plain(*args)
        torch.cuda.synchronize()
        for name, g, a, w in zip(("sumθ", "scatter"), got, again, want):
            err = float((g - w).abs().max())
            excess = float(((g - w).abs() - (THETA_ATOL + THETA_RTOL * w.abs())).max())
            print(f"θ kernel vs plain (R, D, V, K)=({R}, {D}, {V}, {K}) {name}: "
                  f"max|kernel - plain| = {err:.3e}, repeat launch bit-identical: "
                  f"{bool(torch.equal(g, a))}")
            if not torch.isfinite(g).all():
                fail(f"θ kernel {name} not finite at {(R, D, V, K)}")
            if excess > 0:
                fail(f"θ kernel {name} disagrees with its plain version beyond rtol "
                     f"{THETA_RTOL}, atol {THETA_ATOL} at {(R, D, V, K)}")
            if not torch.equal(g, a):
                fail(f"two θ kernel launches on the same inputs differ at {(R, D, V, K)}")
            max_err = max(max_err, err)
        if R == RESTARTS:
            ms = cuda_ms(lambda: tk.theta_moments_fused(*args))
            plain_ms = cuda_ms(lambda: tk.theta_moments_fused_plain(*args))
            timings[V] = (ms, plain_ms)
            print(f"θ time at ({R}, {D}, {V}, {K}): kernel {ms:.4f} ms, plain PyTorch "
                  f"{plain_ms:.4f} ms (median of 20 CUDA-event timings)")
    return max_err, timings[96]


def load_brca():
    """The BRCA-EU counts as dense (D, V_m) arrays, and the term names."""
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
    from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

    tables = [read_counts_tsv(brca_counts_path(f)) for f in BRCA_FILES]
    return [t[0].T for t in tables], [t[1] for t in tables]


def brca_features(snv_terms, sv_terms):
    """(V, 2) 1-based feature tables as tools/families_bench.py:66-77 derives
    them: substitution × trinucleotide context for the SNV terms
    ("A[C->A]G"), type × size/region for the SV terms ("del:<10kb:0-1")."""
    import numpy as np

    subs = sorted({t.split("[")[1].split("]")[0] for t in snv_terms})
    ctx = sorted({t.split("[")[0] + "_" + t.split("]")[1] for t in snv_terms})
    snv = np.array([[subs.index(t.split("[")[1].split("]")[0]) + 1,
                     ctx.index(t.split("[")[0] + "_" + t.split("]")[1]) + 1] for t in snv_terms])
    svt = sorted({t.split(":")[0] for t in sv_terms})
    svr = sorted({":".join(t.split(":")[1:]) for t in sv_terms})
    sv = np.array([[svt.index(t.split(":")[0]) + 1, svr.index(":".join(t.split(":")[1:])) + 1]
                   for t in sv_terms])
    return [snv, sv]


def reset_counts(kernels):
    for k in kernels:
        k.LAUNCHES = 0


def ll_gates(label, ll, reference):
    """Prints and checks the quality gates of an (R, M) ll: at least 99
    finite lanes, and the best ll per modality no more than LL_SLACK below
    the JAX package's CPU value."""
    import numpy as np

    finite = np.isfinite(ll).all(axis=1)
    best = np.max(np.where(np.isfinite(ll), ll, -np.inf), axis=0)
    print(f"{label}: finite lanes {int(finite.sum())}/{len(ll)}, best ll per modality "
          f"{best.tolist()} (JAX CPU best-of-16 {list(reference)})")
    if finite.sum() < 99:
        fail(f"{label}: only {int(finite.sum())}/{len(ll)} lanes finite")
    for m, (b, ref) in enumerate(zip(best, reference)):
        if not b >= ref - LL_SLACK:
            fail(f"{label}: modality {m}: best ll {b} worse than the JAX value {ref} "
                 f"by more than {LL_SLACK}")


# the f32 CAVI budgets on both sides of a card-vs-CPU check, so only the
# precision differs
CAVI_BUDGETS = dict(lambda_n_iter=3, lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4)


def reference_phase(label, fit):
    """A short fit on the card (f32, kernel path) against the same fit from
    the same seed in float64 on the CPU (plain path): `fit(dtype, device)`
    returns the (R, maxiter, M) ll history."""
    import numpy as np
    import torch

    out = [fit(torch.float32, "cuda").cpu().double().numpy(),
           fit(torch.float64, "cpu").cpu().double().numpy()]
    rel = float(np.max(np.abs(out[0] - out[1]) / np.abs(out[1])))
    print(f"{label} reference check: 2 lanes x 10 iterations, f32 on the card vs f64 on "
          f"the CPU: max relative ll difference {rel:.3e}")
    if not rel < 1e-4:
        fail(f"{label} card fit disagrees with the f64 CPU fit: relative difference {rel:.3e}")


def mmctm_short_fit(mt, X):
    def fit(dtype, device):
        config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, **CAVI_BUDGETS)
        return mt.fit_restarts(SEED, X, config, [0.1, 0.1], restarts=2, maxiter=10,
                               tol=0.0, device=device).ll_history
    return fit


def immctm_short_fit(mt, X, features):
    import torch
    from multimodalmusig_tpu_torch.models import ilda, immctm

    J = tuple(tuple(int(v) for v in f.max(axis=0)) for f in features)

    def fit(dtype, device):
        config = immctm.IMMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, J=J,
                                     **CAVI_BUDGETS)
        F = tuple(ilda.feature_onehots(f, j, dtype, device) for f, j in zip(features, J))
        state = immctm.init(torch.Generator().manual_seed(SEED), config, [[0.1, 0.1]] * 2,
                            restarts=2, device=device)
        return mt.fit_immctm_restarts_from_states(state, X, F, config, maxiter=10,
                                                  tol=0.0).ll_history
    return fit


def sync_probe(mt, X):
    """Counts device→host syncs inside one CAVI step (informational)."""
    import torch
    from multimodalmusig_tpu_torch.models import mmctm as mm

    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    Xt = mm.counts_tensors(X, config, "cuda")
    state = mm.init_with_alpha(torch.Generator().manual_seed(SEED), config, Xt,
                               [0.1, 0.1], restarts=RESTARTS, device="cuda")
    step = mm.fit_step_fn(Xt, mm.counts_per_doc(Xt), config)
    step(state)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"device->host syncs inside one CAVI step: {len(syncs)} {syncs[:3]}")


def main_path_phase(mt, lk, tk, X):
    import numpy as np
    import torch

    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL, device="cuda")
    t0 = time.perf_counter()
    mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw).ll.cpu()
    print(f"main path warm-up run: {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    reset_counts((lk, tk))
    t0 = time.perf_counter()
    res = mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw)
    ll = res.ll.cpu().double().numpy()
    wall = time.perf_counter() - t0
    launches = {"lambda_newton": lk.LAUNCHES, "theta_moments": tk.LAUNCHES}

    iters = res.n_iters.cpu().numpy()
    n = launches["lambda_newton"]
    print(f"main path: R={RESTARTS} BRCA-EU MMCTM K=(7, 7) f32 tol={TOL}: wall {wall:.4f} s, "
          f"{n} CAVI iterations (one λ-kernel launch each), "
          f"{1000 * wall / max(n, 1):.4f} ms per CAVI iteration; kernel launches {launches}")
    print(f"main path: iterations median {float(np.median(iters)):.1f} max {int(iters.max())}, "
          f"converged {int(res.converged.sum())}/{RESTARTS}, "
          f"pick_optimal_restart={int(mt.pick_optimal_restart(res.ll))}")
    if tuple(res.ll.shape) != (RESTARTS, 2) or tuple(res.ll_history.shape) != (RESTARTS, MAXITER, 2):
        fail(f"unexpected result shapes {tuple(res.ll.shape)}, {tuple(res.ll_history.shape)}")
    if min(launches.values()) <= 0:
        fail(f"the main path did not launch both kernels: {launches}")
    ll_gates("main path", ll, JAX_CPU_BEST_LL)
    return launches


def single_model_phase(mt, lk, X):
    import numpy as np
    import torch

    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    before = lk.LAUNCHES
    model = mt.MMCTM([7, 7], [0.1, 0.1], docs, device="cuda")
    history = model.fit(maxiter=30)
    torch.cuda.synchronize()
    print(f"single model: {len(history)} iterations, final ll {model.ll}, "
          f"elbo {model.elbo}, {lk.LAUNCHES - before} λ-kernel launches at R = 1")
    if not (np.isfinite(model.ll).all() and np.isfinite(model.elbo)):
        fail("single-model fit is not finite")
    if lk.LAUNCHES - before != len(history):
        fail("single-model fit did not launch the λ kernel once per iteration")


def immctm_phase(mt, lk, tk, X, features):
    import numpy as np
    import torch

    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(X[0].shape[0])]
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL, device="cuda")
    t0 = time.perf_counter()
    mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, **kw)
    print(f"IMMCTM path warm-up run: {time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    reset_counts((lk, tk))
    t0 = time.perf_counter()
    model = mt.fit_immctm_restarts([7, 7], [0.1, 0.1], features, docs, **kw)
    res = model.restart_result
    ll = res.ll.cpu().double().numpy()
    wall = time.perf_counter() - t0
    launches = {"lambda_newton": lk.LAUNCHES, "theta_moments": tk.LAUNCHES}

    iters = res.n_iters.cpu().numpy()
    n = launches["lambda_newton"]
    print(f"IMMCTM path: R={RESTARTS} BRCA-EU IMMCTM K=(7, 7) J={model.J} f32 tol={TOL}: "
          f"wall {wall:.4f} s (fit, f64 re-score and selection), {n} CAVI iterations, "
          f"{1000 * wall / max(n, 1):.4f} ms per CAVI iteration; kernel launches {launches}")
    print(f"IMMCTM path: iterations median {float(np.median(iters)):.1f} max {int(iters.max())}, "
          f"converged {int(res.converged.sum())}/{RESTARTS}, selected lane ll {model.ll}")
    if tuple(res.ll.shape) != (RESTARTS, 2) or len(model.ll) != 2:
        fail(f"unexpected IMMCTM result shapes {tuple(res.ll.shape)}, {model.ll}")
    if min(launches.values()) <= 0:
        fail(f"the IMMCTM path did not launch both kernels: {launches}")
    ll_gates("IMMCTM path", ll, JAX_CPU_BEST_IMMCTM_LL)
    if not np.isfinite(model.ll).all():
        fail(f"the selected IMMCTM lane is not finite: {model.ll}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import multimodalmusig_tpu_torch as mt
    from multimodalmusig_tpu_torch.ops import lambda_kernel as lk
    from multimodalmusig_tpu_torch.ops import theta_kernel as tk

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); nvidia-smi: {smi}")

    def timed_build(kernel):
        t0 = time.perf_counter()
        return kernel.build(), time.perf_counter() - t0

    with ThreadPoolExecutor(2) as pool:  # one nvcc per source, started together
        builds = list(pool.map(timed_build, (lk, tk)))
    for lib, sec in builds:
        print(f"build: {sec:.2f} s ({lib})")
        with open(lib.rsplit("/", 1)[0] + "/build.log") as f:
            print("build log:\n" + f.read().strip())

    lam_err, (lam_ms, lam_plain_ms) = lambda_phase(lk)
    theta_err, (theta_ms, theta_plain_ms) = theta_phase(tk)
    X, terms = load_brca()
    features = brca_features(*terms)
    reference_phase("MMCTM", mmctm_short_fit(mt, X))
    reference_phase("IMMCTM", immctm_short_fit(mt, X, features))
    sync_probe(mt, X)
    mmctm_launches = main_path_phase(mt, lk, tk, X)
    single_model_phase(mt, lk, X)
    immctm_launches = immctm_phase(mt, lk, tk, X, features)
    launches = {k: mmctm_launches[k] + immctm_launches[k] for k in mmctm_launches}
    print(f"kernel launches on the driven paths: MMCTM {mmctm_launches}, IMMCTM {immctm_launches}")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "lambda_newton",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/lambda_newton.cu",
        "replaces": "multimodalmusig_tpu/ops/pallas/lambda_kernel.py:264",
        "launches": launches["lambda_newton"],
        "max_abs_err": lam_err,
        "ms": lam_ms,
        "plain_ms": lam_plain_ms,
    }, {
        "name": "theta_moments",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/theta_moments.cu",
        "replaces": "tools/pallas_experiments/theta_kernel.py:83",
        "launches": launches["theta_moments"],
        "max_abs_err": theta_err,
        "ms": theta_ms,
        "plain_ms": theta_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
