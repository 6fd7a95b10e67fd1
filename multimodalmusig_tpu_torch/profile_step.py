"""Where one CAVI iteration of the restart fit spends its time on a CUDA card.

    python -m multimodalmusig_tpu_torch.profile_step [--restarts 100] [--steps 20]

Runs the main path's iteration (MMCTM K=(7, 7), α=0.1, float32, on the
bundled BRCA-EU counts) for `--restarts` lanes on the card and prints:
  * the host-clock time per iteration (synchronized), the kernel launches
    per iteration and the device-busy share (summed kernel time over wall
    time) from torch.profiler;
  * the time per phase of the iteration (θ moments, ζ, ν solve, λ solve,
    M-step, γ, log-likelihoods, and the rest: N/ζ, μ, lane freezing), each
    synchronized, so a phase's time includes the launches it issues;
  * the kernels by device time;
  * the iteration time with the plain PyTorch λ solver in place of the CUDA
    kernel, in turns kernel, plain, plain, kernel.
Needs a CUDA card; exits with an error without one.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from .models import ctm_base, mmctm
from .ops import lambda_kernel
from .utils.data import BRCA_FILES, brca_counts_path
from .utils.fast_tsv import read_counts_tsv

# (label, module, function name) of the phases wrapped for timing
_PHASES = (
    ("theta moments", mmctm, "theta_moments"),
    ("zeta", ctm_base, "update_zeta"),
    ("nu solve", ctm_base, "maximize_nu"),
    ("lambda solve", ctm_base, "solve_lambda"),
    ("M-step (mu, Sigma, Sigma^-1)", mmctm, "update_Sigma"),
    ("gamma, E[ln phi]", mmctm, "update_gamma"),
    ("log-likelihoods", mmctm, "modality_loglikelihoods"),
)


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
        return ctm_base._select_lanes(active, new, s), ll

    for _ in range(10):  # leave the cold start behind
        state, _ = iteration(state)
    torch.cuda.synchronize()
    return state, iteration


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
    lambda_kernel.build()
    with ctm_base.full_f32_matmuls():
        state, iteration = _setup(args.restarts)
        steps = args.steps

        kernel_solve = lambda_kernel.maximize_lambda_restarts
        plain = lambda_kernel.maximize_lambda_restarts_plain
        arms = []
        for use_plain in (False, True, True, False):
            lambda_kernel.maximize_lambda_restarts = plain if use_plain else kernel_solve
            try:
                arms.append(("plain" if use_plain else "kernel", _wall_ms(iteration, state, steps)))
            finally:
                lambda_kernel.maximize_lambda_restarts = kernel_solve
        print(f"ms per CAVI iteration at R={args.restarts} (host clock, synchronized, "
              f"{steps} iterations each): " + ", ".join(f"{n} {ms:.4f}" for n, ms in arms))

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = iteration(state)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        print(f"profiled: {wall_us / steps / 1000:.4f} ms per iteration (profiler on), "
              f"{len(kernels) / steps:.1f} kernels per iteration, device busy "
              f"{busy_us / steps / 1000:.4f} ms per iteration = {100 * busy_us / wall_us:.1f}% of wall")
        print(prof.key_averages().table(sort_by="device_time_total", row_limit=25))

        timings = {label: 0.0 for label, _, _ in _PHASES}
        originals = {}

        def timed(label, fn):
            def inner(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                timings[label] += time.perf_counter() - t0
                return out
            return inner

        for label, mod, name in _PHASES:
            originals[(mod, name)] = getattr(mod, name)
            setattr(mod, name, timed(label, originals[(mod, name)]))
        try:
            wall = _wall_ms(iteration, state, steps)
        finally:
            for (mod, name), fn in originals.items():
                setattr(mod, name, fn)
        print(f"per phase, each synchronized ({wall:.4f} ms per iteration with the syncs):")
        for label, sec in timings.items():
            print(f"  {label:32s} {1000 * sec / steps:8.4f} ms")
        rest = wall - 1000 * sum(timings.values()) / steps
        print(f"  {'rest (N/zeta, mu, lane freezing)':32s} {rest:8.4f} ms")


if __name__ == "__main__":
    main()
