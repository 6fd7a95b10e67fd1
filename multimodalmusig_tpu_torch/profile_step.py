"""Where one CAVI iteration of the restart fit spends its time on a CUDA card.

    python -m multimodalmusig_tpu_torch.profile_step [--restarts 100] [--steps 20]

Runs the main path's iteration (MMCTM K=(7, 7), α=0.1, float32, on the
bundled BRCA-EU counts) for `--restarts` lanes on the card and prints:
  * the host-clock time per iteration (synchronized), the kernel launches
    per iteration and the device-busy share (summed kernel time over wall
    time) from torch.profiler;
  * the host time per phase of the iteration, from the program's own spans
    (utils/profiling.py, recorded under `profiling.tracing()`, with no
    synchronization inside: what the host takes to issue each phase): the
    E-step (θ moments and η), the M-step (μ, Σ, Σ⁻¹), γ, the
    log-likelihoods, the kernels' wrappers, and the lane freeze outside the
    step, on the fused and on the split η route;
  * the kernels by device time, and the device time per call of each of
    the port's kernels (η, λ, θ, the θ kernel also per modality), on both
    η routes;
  * the iteration time in turns on the kernels (the fused η route), the
    split η route (PyTorch ζ/ν and the λ kernel), the plain η side (PyTorch
    ζ/ν and the plain λ solver) and the factorized θ schedule in place of
    the θ kernel: kernels, split η, plain η, factorized θ, factorized θ,
    plain η, split η, kernels, twice;
  * the host time of one θ-moments call (both modalities) by each route,
    over 200 back-to-back calls with no synchronization inside, which is
    what a launch-bound iteration pays.
Needs a CUDA card; exits with an error without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .models import ctm_base, mmctm
from .ops import estep_kernel, lambda_kernel, theta_kernel
from .utils import profiling
from .utils.data import BRCA_FILES, brca_counts_path
from .utils.fast_tsv import read_counts_tsv

# The iteration's variants, in turns: the kernels (fused η route); the split
# η route; the split route with the plain λ solver; the factorized θ schedule.
_ARMS = ("kernels", "split η", "plain η", "factorized θ",
         "factorized θ", "plain η", "split η", "kernels")
# The port's kernels by the name of their device functions.
_KERNELS = (("eta (B3)", "estep_eta"), ("lambda (B1)", "lambda_newton"), ("theta (B4)", "theta"))
# The program's spans of one iteration, as printed per phase.
_SPANS = (("E-step (theta moments, eta)", "step.estep"),
          ("M-step (mu, Sigma, Sigma^-1)", "step.mstep"),
          ("gamma, E[ln phi]", "step.gamma"), ("log-likelihoods", "step.ll"),
          ("  eta kernel wrapper (B3)", "kernel.eta_host"),
          ("  theta kernel wrapper (B4)", "kernel.theta_host"))


def _select_lanes(keep: torch.Tensor, new, old):
    """Per-lane torch.where over a state (tensors and tuples of tensors):
    the lane freeze of the fit loop, eagerly and out of place."""
    if isinstance(new, tuple):
        parts = [_select_lanes(keep, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    return torch.where(keep.view(-1, *([1] * (new.dim() - 1))), new, old)


def _setup(restarts: int):
    X = [read_counts_tsv(brca_counts_path(f))[0].T for f in BRCA_FILES]
    config = mmctm.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=torch.float32)
    Xt = mmctm.counts_tensors(X, config, "cuda")
    state = mmctm.init_with_alpha(torch.Generator().manual_seed(0), config, Xt, [0.1, 0.1],
                                  restarts=restarts, device="cuda")
    step = mmctm.fit_step_fn(Xt, ctm_base.counts_per_doc(Xt), config)
    active = torch.ones(restarts, dtype=torch.bool, device="cuda")

    def iteration(s):
        new, ll = step(s)
        return _select_lanes(active, new, s), ll

    for _ in range(10):  # leave the cold start behind
        state, _ = iteration(state)
    torch.cuda.synchronize()
    return state, iteration, Xt, config


def _wall_ms(iteration, state, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = iteration(state)
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / steps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--restarts", type=int, default=100)
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step: needs a CUDA card")
    estep_kernel.build()
    lambda_kernel.build()
    theta_kernel.build()
    with ctm_base.full_f32_matmuls():
        state, iteration, X, config = _setup(args.restarts)
        steps = args.steps

        kernel_solve = lambda_kernel.maximize_lambda_restarts
        plain_solve = lambda_kernel.maximize_lambda_restarts_plain
        theta_route, eta_route = ctm_base._theta_route, ctm_base._eta_route

        def split(*a):
            return "split"

        arms = []
        for arm in _ARMS * 2:
            if arm in ("split η", "plain η"):
                ctm_base._eta_route = split
            if arm == "plain η":
                lambda_kernel.maximize_lambda_restarts = plain_solve
            if arm == "factorized θ":
                ctm_base._theta_route = lambda *a: "factorized"
            try:
                arms.append((arm, _wall_ms(iteration, state, steps)))
            finally:
                lambda_kernel.maximize_lambda_restarts = kernel_solve
                ctm_base._theta_route = theta_route
                ctm_base._eta_route = eta_route
        print(f"ms per CAVI iteration at R={args.restarts} (host clock, synchronized, "
              f"{steps} iterations each): " + ", ".join(f"{n} {ms:.4f}" for n, ms in arms))

        logw = mmctm.smoothed_logw(state)
        for route in ("kernel", "factorized", "factorized", "kernel"):
            ctm_base._theta_route = lambda *a, route=route: route
            try:
                ctm_base.theta_moments(state.lam, logw, X, config)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    ctm_base.theta_moments(state.lam, logw, X, config)
                torch.cuda.synchronize()
                us = 1e6 * (time.perf_counter() - t0) / 200
            finally:
                ctm_base._theta_route = theta_route
            print(f"theta moments by the {route} route: {us:.1f} us per call "
                  "(host clock, 200 calls, one synchronize)")

        from torch.profiler import ProfilerActivity, profile

        for route in ("fused", "split"):
            ctm_base._eta_route = eta_route if route == "fused" else split
            try:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        state, _ = iteration(state)
                    torch.cuda.synchronize()
                    wall_us = 1e6 * (time.perf_counter() - t0)
            finally:
                ctm_base._eta_route = eta_route
            kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.time_range.elapsed_us() for e in kernels)
            print(f"profiled, {route} η route: {wall_us / steps / 1000:.4f} ms per iteration "
                  f"(profiler on), {len(kernels) / steps:.1f} kernels per iteration, device busy "
                  f"{busy_us / steps / 1000:.4f} ms per iteration = "
                  f"{100 * busy_us / wall_us:.1f}% of wall")
            print(f"device time per call of the port's kernels, {route} η route:")
            for label, key in _KERNELS:
                calls = [e for e in kernels if key in e.name]
                if calls:
                    total = sum(e.time_range.elapsed_us() for e in calls)
                    print(f"  {label:12s} {len(calls) / steps:5.1f} calls per iteration, "
                          f"{total / len(calls):9.2f} us per call")
                else:
                    print(f"  {label:12s}   0.0 calls per iteration")
                if key == "theta" and calls:  # one call per modality, in modality order
                    calls.sort(key=lambda e: e.time_range.start)
                    for m, V in enumerate(config.V):
                        per = [e.time_range.elapsed_us() for e in calls[m::config.M]]
                        print(f"    modality {m} (V={V}): {sum(per) / len(per):9.2f} us per call")
            print(prof.key_averages().table(sort_by="device_time_total", row_limit=25))

        for route in ("fused", "split"):
            ctm_base._eta_route = eta_route if route == "fused" else split
            profiling.reset()
            try:
                with profiling.tracing():
                    wall = _wall_ms(iteration, state, steps)
            finally:
                ctm_base._eta_route = eta_route
            spans = profiling.totals()["spans"]
            profiling.reset()
            print(f"host time per phase on the {route} η route, from the program's spans, "
                  f"unsynchronized ({wall:.4f} ms per iteration, recording on):")
            for label, name in _SPANS:
                ms = 1000 * spans.get(name, {}).get("s", 0.0) / steps
                print(f"  {label:32s} {ms:8.4f} ms")
            step_ms = 1000 * spans["step"]["s"] / steps
            print(f"  {'the step (the phases above)':32s} {step_ms:8.4f} ms")
            print(f"  {'lane freeze and the wait':32s} {wall - step_ms:8.4f} ms")

if __name__ == "__main__":
    main()
