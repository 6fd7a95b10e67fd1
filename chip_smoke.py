#!/usr/bin/env python3
"""Smoke run of the PyTorch port (multimodalmusig_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on any error:
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the λ Newton/PCG kernel (csrc/lambda_newton.cu) with
     nvcc for sm_90a and prints the build time and ptxas report;
  3. kernel against its plain PyTorch version, both on the card, on seeded
     SPD problems at the main path's shape (100, 560, 14) with the f32 CAVI
     budgets (warm start) and the cold defaults, and at a ragged D=33, MK=19;
     prints both times (median of CUDA-event timings);
  4. main path: the best-of-100 MMCTM K=(7, 7), α=0.1 restart fit on the
     bundled BRCA-EU SNV+SV counts (D=560), float32, tol 1e-5, maxiter 1000,
     through `fit_restarts(..., device="cuda")`, once warm and once timed;
     checks that it went through the kernel, that at least 99 lanes are
     finite and that the best ll per modality is within 5e-3 of the JAX
     package's value; a short fit on the card is also held against the same
     fit in float64 on the CPU;
  5. single model: `MMCTM([7, 7], [0.1, 0.1], X, device="cuda").fit(maxiter=30)`,
     the kernel's R = 1 entry.
The last two lines of standard output are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time
import warnings

SEED = 147959412
RESTARTS = 100
TOL = 1e-5
MAXITER = 1000
KERNEL_ATOL = 5e-5
STATIONARITY_TOL = 1e-2
LL_SLACK = 5e-3
# Best finite ll per modality of the JAX package's best-of-16 fit of the same
# workload on the CPU, float32 (16/16 lanes finite):
#   fit_restarts(jax.random.key(147959412), X,
#                MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=jnp.float32),
#                jnp.asarray([0.1, 0.1], jnp.float32), restarts=16,
#                maxiter=1000, tol=1e-5)   # multimodalmusig_tpu.parallel.restarts
JAX_CPU_BEST_LL = (-3.93717622756958, -3.035710334777832)


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


def kernel_phase(mt, lk):
    import torch
    from multimodalmusig_tpu_torch.ops.solvers import (
        CG_F32_CAVI, LAMBDA_NITER_F32_CAVI, LAMBDA_POLISH_F32_CAVI, lambda_grad,
    )

    cavi = dict(n_iter=LAMBDA_NITER_F32_CAVI, cg_iter=CG_F32_CAVI,
                polish_iter=LAMBDA_POLISH_F32_CAVI)
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    timing = None
    for label, (R, D, MK), budgets, warm in (
        ("main-path shape, f32 CAVI budgets, warm start", (RESTARTS, 560, 14), cavi, True),
        ("main-path shape, cold defaults", (RESTARTS, 560, 14), {}, False),
        ("ragged D=33, MK=19, cold defaults", (3, 33, 19), {}, False),
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
        print(f"kernel vs plain [{label}] (R, D, MK)=({R}, {D}, {MK}): "
              f"max|kernel - plain| = {err:.3e}, max|grad| at kernel result = {gmax:.3e}")
        if not torch.isfinite(got).all():
            fail(f"kernel result not finite [{label}]")
        if err > KERNEL_ATOL:
            fail(f"kernel disagrees with its plain version by {err:.3e} > {KERNEL_ATOL} [{label}]")
        if gmax > STATIONARITY_TOL:
            fail(f"kernel result not stationary: |g| = {gmax:.3e} [{label}]")
        max_err = max(max_err, err)
        if timing is None:
            ms = cuda_ms(lambda: lk.maximize_lambda_restarts(*args, **budgets))
            plain_ms = cuda_ms(lambda: lk.maximize_lambda_restarts_plain(*args, **budgets))
            timing = (ms, plain_ms)
            print(f"time at (100, 560, 14), f32 CAVI budgets: kernel {ms:.4f} ms, "
                  f"plain PyTorch {plain_ms:.4f} ms (median of 20 CUDA-event timings)")
    return max_err, timing


def load_brca():
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
    from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

    return [read_counts_tsv(brca_counts_path(f))[0].T for f in BRCA_FILES]


def reference_phase(mt, X):
    """A short fit on the card (f32, kernel path) against the same fit from
    the same seed in float64 on the CPU (plain path)."""
    import numpy as np
    import torch

    out = []
    for dtype, device in ((torch.float32, "cuda"), (torch.float64, "cpu")):
        # the f32 CAVI budgets on both sides, so only the precision differs
        config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, lambda_n_iter=3,
                                lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4)
        res = mt.fit_restarts(SEED, X, config, [0.1, 0.1], restarts=2, maxiter=10,
                              tol=0.0, device=device)
        out.append(res.ll_history.cpu().double().numpy())
    rel = float(np.max(np.abs(out[0] - out[1]) / np.abs(out[1])))
    print(f"reference check: 2 lanes x 10 iterations, f32 on the card vs f64 on "
          f"the CPU: max relative ll difference {rel:.3e}")
    if not rel < 1e-4:
        fail(f"card fit disagrees with the f64 CPU fit: relative difference {rel:.3e}")


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


def main_path_phase(mt, lk, X):
    import numpy as np
    import torch

    config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    kw = dict(restarts=RESTARTS, maxiter=MAXITER, tol=TOL, device="cuda")
    t0 = time.perf_counter()
    mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw).ll.cpu()
    print(f"main path warm-up run: {time.perf_counter() - t0:.3f} s")

    lk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mt.fit_restarts(SEED, X, config, [0.1, 0.1], **kw)
    ll = res.ll.cpu().double().numpy()
    wall = time.perf_counter() - t0
    launches = lk.LAUNCHES

    iters = res.n_iters.cpu().numpy()
    finite = np.isfinite(ll).all(axis=1)
    best = np.max(np.where(np.isfinite(ll), ll, -np.inf), axis=0)
    print(f"main path: R={RESTARTS} BRCA-EU MMCTM K=(7, 7) f32 tol={TOL}: wall {wall:.4f} s, "
          f"{launches} CAVI iterations (one λ-kernel launch each), "
          f"{1000 * wall / max(launches, 1):.4f} ms per CAVI iteration")
    print(f"main path: iterations median {float(np.median(iters)):.1f} max {int(iters.max())}, "
          f"converged {int(res.converged.sum())}/{RESTARTS}, finite lanes {int(finite.sum())}/{RESTARTS}, "
          f"best ll per modality {best.tolist()} (JAX CPU best-of-16 {list(JAX_CPU_BEST_LL)}), "
          f"pick_optimal_restart={int(mt.pick_optimal_restart(res.ll))}")
    if tuple(res.ll.shape) != (RESTARTS, 2) or tuple(res.ll_history.shape) != (RESTARTS, MAXITER, 2):
        fail(f"unexpected result shapes {tuple(res.ll.shape)}, {tuple(res.ll_history.shape)}")
    if launches <= 0:
        fail("the main path never launched the λ kernel")
    if finite.sum() < 99:
        fail(f"only {int(finite.sum())}/{RESTARTS} lanes finite")
    for m, (b, ref) in enumerate(zip(best, JAX_CPU_BEST_LL)):
        if not b >= ref - LL_SLACK:
            fail(f"modality {m}: best ll {b} worse than the JAX value {ref} by more than {LL_SLACK}")
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import multimodalmusig_tpu_torch as mt
    from multimodalmusig_tpu_torch.ops import lambda_kernel as lk

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}); nvidia-smi: {smi}")

    t0 = time.perf_counter()
    lib = lk.build()
    print(f"build: {time.perf_counter() - t0:.2f} s ({lib})")
    with open(lib.rsplit("/", 1)[0] + "/build.log") as f:
        print("build log:\n" + f.read().strip())

    max_err, (ms, plain_ms) = kernel_phase(mt, lk)
    X = load_brca()
    reference_phase(mt, X)
    sync_probe(mt, X)
    launches = main_path_phase(mt, lk, X)
    single_model_phase(mt, lk, X)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "lambda_newton",
        "route": "cuda",
        "source": "multimodalmusig_tpu_torch/csrc/lambda_newton.cu",
        "replaces": "multimodalmusig_tpu/ops/pallas/lambda_kernel.py:264",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
