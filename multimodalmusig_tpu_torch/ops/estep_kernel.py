"""The fused η side of the E-step: CUDA kernel, its wrapper, its plain version.

Counterpart of tools/pallas_experiments/estep_kernel.py, restart-batched as
ops/lambda_kernel.py is. For every restart lane and document it computes
ζ, then N/ζ, then the ν solve, then the λ solve, in one launch. The kernel
(csrc/estep_eta.cu, which documents its design and bounds; its λ solve is
csrc/lambda_solve.cuh, shared with the λ kernel) is compiled by nvcc for
sm_90a on first use (native_build.py) and bound through its plain C
interface with ctypes.

Dispatch is by device only: a CPU tensor takes the plain PyTorch version
(`estep_eta_fused_plain`, the port's update_zeta → calculate_Ndivzeta →
maximize_nu → maximize_lambda at the kernel's defaults); a CUDA tensor
launches the kernel, or raises when it cannot be built or launched — there
is no fallback. `LAUNCHES` counts the kernel's launches, so a run can show
that its path went through the kernel. `launch_geometry` picks the kernel's
layout from MK and the number of problems R·D, and the wrapper passes it to
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..native_build import cuda_function
from ..utils import profiling
from .solvers import CG_ITER_F32_CAP, LAMBDA_POLISH_ITERS, NU_FP_ITERS, maximize_lambda

__all__ = [
    "estep_eta_fused",
    "estep_eta_fused_plain",
    "build",
    "KERNEL_MAX_MK",
    "LAUNCHES",
    "EtaGeometry",
    "launch_geometry",
]

# The TPU kernel's PALLAS_MAX_MK, as for the λ kernel.
KERNEL_MAX_MK = 128

# Kernel launches since import (or since a caller last reset it to 0).
LAUNCHES = 0

# The layouts' reach, from B3's own times (lambda_bench.py --eta on an
# NVIDIA H100, PERF.md §6). At MK ≤ 32 a call of fewer (restart, document)
# problems R·D than `_few_problems(MK)` takes the warp layout, a group of 16
# or 32 lanes per problem in blocks of WARP_DOCS problems: there the time is
# one problem's chain of dependent steps, and the crossover grows with the
# work of the layout it gives way to. Above it: one thread per problem at
# MK ≤ 16; a pair of threads at MK 17–28, and at MK 29–32 up to
# PAIR16_MAX_PROBLEMS (three waves of the pair at P = 16: 2 blocks of 64
# problems on each of 132 SMs); one thread (P = 32) beyond. Above MK 32:
# below `_few_problems(MK)` problems the block layout (a BlockGroup of 64 or
# 128 lanes per problem), else 4 threads per problem at MK 33–64 and 8 at
# MK 65–128 ("split4", "split8").
GROUP_MAX_MK = 32
THREAD_MAX_MK = 16
PAIR_MAX_MK = 28
SPLIT4_MAX_MK = 64
PAIR16_MAX_PROBLEMS = 3 * 2 * 64 * 132
# Above MK 32, the problems R·D below which the block layout beats split4
# or split8, by the split layout's P: the crossover measured at MK 40, 48,
# 56, 64, 65, 80, 96, 112 and 128 (R·D from 560 to 5,600). It grows with
# the work of one thread's chain, which sets a split layout's time until
# its first wave is full, and falls where the block layout pads (split8 at
# P = 10 beat BlockGroup<128> from 560 problems on).
BLOCK_MAX_PROBLEMS = {("split4", 10): 1000, ("split4", 12): 1500, ("split4", 14): 2000,
                      ("split4", 16): 3000, ("split8", 10): 500, ("split8", 12): 700,
                      ("split8", 14): 1000, ("split8", 16): 1500}
WARP_DOCS = {16: 4, 32: 8}
THREAD_DOCS = 64
# The kernel's instantiations: the thread layout's coordinates per thread
# (P ≥ MK), the pair's, split4's and split8's per thread of a problem
# (Split·P ≥ MK).
THREAD_P = (2, 4, 6, 8, 10, 12, 14, 16, 32)
PAIR_P = (10, 12, 14, 16)
# The kernel's layout codes (csrc/estep_eta.cu).
_LAYOUTS = {"thread": 0, "pair": 1, "warp": 2, "block": 3, "split4": 4, "split8": 5}

# lam0, nu, N, sumtheta, mu, invSigma, lam_prev (or null), zeta, nu_out,
# lam_out, K; M, R, D, MK, n_iter, cg_iter, polish_iter, nu_n_iter; extrap;
# layout, P, documents per block; stream
_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


class EtaGeometry(NamedTuple):
    """The η kernel's launch: `layout` "thread" (one thread per (restart,
    document) problem, holding P ≥ MK coordinates), "pair", "split4" or
    "split8" (2, 4 or 8 threads per problem, P ≥ MK/2, MK/4 or MK/8
    coordinates each), "warp" (a P-lane group per problem inside one warp)
    or "block" (a P-lane group of whole warps); `docs_per_block` documents
    of one restart per block."""

    layout: str
    P: int
    docs_per_block: int


def _check_mk(MK):
    if not 1 <= MK <= KERNEL_MAX_MK:
        raise ValueError(f"MK={MK} is outside the η kernel's 1..{KERNEL_MAX_MK}")


def _thread_P(MK):
    return min(p for p in THREAD_P if p >= MK)


def _pair_P(MK, split=2):
    return min(p for p in PAIR_P if split * p >= MK)


def _split_docs(split):
    """Documents a block of split4 and split8 (csrc/estep_eta.cu
    max_docs): blocks of 128 threads."""
    return 128 // split


def _split_geometry(MK):
    """split4 at MK 33–64, split8 at MK 65–128, each at its least P."""
    split = 4 if MK <= SPLIT4_MAX_MK else 8
    P = _pair_P(MK, split)
    return EtaGeometry(f"split{split}", P, _split_docs(split))


def _group_P(MK):
    return min(p for p in (16, 32, 64, 128) if p >= MK)


def _few_problems(MK):
    """The problems R·D below which a call takes the warp layout (MK ≤ 32)
    or the block layout (MK > 32): at MK ≤ 14 650 per coordinate of the
    thread layout's P (the crossover measured at P = 4, 8, 10, 12 and 14);
    at MK 15 the same, at MK 16 (the 16-lane group full) 20,480; at MK
    17–24 3,168, the warp's one wave (132 SMs × 3 blocks × 8 problems); at
    MK 25–28 4,352; at MK 29–31 6,144, at MK 32 (the 32-lane group full)
    10,240; above MK 32 BLOCK_MAX_PROBLEMS of the split layout that takes
    over."""
    if MK > GROUP_MAX_MK:
        geo = _split_geometry(MK)
        return BLOCK_MAX_PROBLEMS[geo.layout, geo.P]
    if MK <= THREAD_MAX_MK:
        return 20480 if MK == 16 else 650 * _thread_P(MK)
    if MK <= 24:
        return 3168
    if MK <= PAIR_MAX_MK:
        return 4352
    return 10240 if MK == 32 else 6144


@functools.lru_cache(maxsize=None)
def launch_geometry(R: int, D: int, MK: int) -> EtaGeometry:
    """Below `_few_problems(MK)` problems R·D (stage 2, inference,
    single-model fits, ranks): a warp group of 16 or 32 lanes per problem
    at MK ≤ 32, a BlockGroup of 64 or 128 lanes (256 threads a block)
    above. Else one thread per problem at MK ≤ 16 (P = MK rounded up to
    even), a pair of threads at MK 17–28 (P the least of PAIR_P with
    2P ≥ MK) and at MK 29–32 up to PAIR16_MAX_PROBLEMS, one thread (P = 32)
    beyond, 64 documents a block (D = 560 fills 560 of 576 threads); 4
    threads per problem at MK 33–64 and 8 at MK 65–128 (`_split_geometry`)."""
    _check_mk(MK)
    if not (R >= 1 and D >= 1):
        raise ValueError(f"R={R} and D={D} must be positive")
    P = _group_P(MK)
    if MK > GROUP_MAX_MK:
        if R * D < _few_problems(MK):
            return EtaGeometry("block", P, 256 // P)
        return _split_geometry(MK)
    if R * D < _few_problems(MK):
        return EtaGeometry("warp", P, WARP_DOCS[P])
    if MK <= THREAD_MAX_MK or (MK > PAIR_MAX_MK and R * D > PAIR16_MAX_PROBLEMS):
        return EtaGeometry("thread", _thread_P(MK), THREAD_DOCS)
    return EtaGeometry("pair", _pair_P(MK), THREAD_DOCS)


def _candidate_geometries(MK: int) -> Tuple[EtaGeometry, ...]:
    """Every layout the kernel can run an MK with, each at its smallest P,
    for measurements and tests: at MK ≤ 32 the thread layout, the pair at
    MK 17–32 (64 documents a block) and the warp layout in blocks of 64 and
    of 256 threads; above, split4 (MK ≤ 64) or split8, and the block
    layout."""
    _check_mk(MK)
    P = _group_P(MK)
    if MK > GROUP_MAX_MK:
        return (_split_geometry(MK), EtaGeometry("block", P, 256 // P))
    pair = (EtaGeometry("pair", _pair_P(MK), THREAD_DOCS),) if MK > 16 else ()
    return (EtaGeometry("thread", _thread_P(MK), THREAD_DOCS), *pair,
            EtaGeometry("warp", P, 64 // P), EtaGeometry("warp", P, 256 // P))


def _check_geometry(geo: EtaGeometry, MK: int):
    """Raises ValueError unless the kernel takes `geo` at this MK (the
    rules of csrc/estep_eta.cu estep_eta_launch)."""
    layout, P, docs = geo
    ok = {
        "thread": P in THREAD_P and P >= MK and 1 <= docs <= THREAD_DOCS,
        "pair": P in PAIR_P and 2 * P >= MK and docs in (16, 32, 48, 64),
        # whole warps of problems, at most 128 threads a block
        "split4": P in PAIR_P and 4 * P >= MK and 1 <= docs <= 32 and docs % 8 == 0,
        "split8": P in PAIR_P and 8 * P >= MK and 1 <= docs <= 16 and docs % 4 == 0,
        "warp": P in (16, 32) and P >= MK and docs >= 1 and docs * P % 32 == 0
        and docs * P <= 256,
        "block": P in (64, 128) and P >= MK and docs == 256 // P,
    }.get(layout, False)
    if not ok:
        raise ValueError(f"the η kernel has no launch {geo} at MK={MK}")


def build() -> str:
    """Compile the kernel (once per source/header/flag hash) and load it;
    return the library's path. Raises if nvcc is missing or the compile
    fails."""
    return cuda_function("estep_eta", "estep_eta_launch", _ARGTYPES)[0]


def _defaults(MK, cg_iter, polish_iter, nu_n_iter):
    """The TPU kernel's defaults for the budgets left as None: cg_iter =
    min(MK, CG_ITER_F32_CAP), polish LAMBDA_POLISH_ITERS, ν sweeps
    NU_FP_ITERS."""
    return (min(MK, CG_ITER_F32_CAP) if cg_iter is None else int(cg_iter),
            LAMBDA_POLISH_ITERS if polish_iter is None else int(polish_iter),
            NU_FP_ITERS if nu_n_iter is None else int(nu_n_iter))


def _check_K(K, MK):
    K = tuple(int(k) for k in K)
    if not K or min(K) < 1 or sum(K) != MK:
        raise ValueError(f"K={K} must be positive topic counts summing to MK={MK}")
    return K


def estep_eta_fused_plain(lam0, nu, N, sumtheta, mu, invSigma, K, n_iter: int = 7,
                          cg_iter: int = None, polish_iter: int = None,
                          nu_n_iter: int = None, lam_prev=None, extrap=None):
    """The plain PyTorch version of the kernel: ζ and N/ζ from the incoming
    λ and ν, the ν solve from the incoming λ, the λ solve with the new ν
    from ops/solvers.extrapolated_start(λ, lam_prev, extrap)
    (models/ctm_base.split_eta with ops/solvers.maximize_lambda), at the
    same defaults."""
    from ..models import ctm_base  # ctm_base routes to this module

    MK = lam0.shape[-1]
    K = _check_K(K, MK)
    cg_iter, polish_iter, nu_n_iter = _defaults(MK, cg_iter, polish_iter, nu_n_iter)
    config = ctm_base.CTMBaseConfig(K=K, V=(0,) * len(K), D=lam0.shape[-2])
    return ctm_base.split_eta(lam0, nu, N, sumtheta, mu, invSigma, config, maximize_lambda,
                              nu_n_iter=nu_n_iter, lam_prev=lam_prev, extrap=extrap,
                              n_iter=n_iter, cg_iter=cg_iter, polish_iter=polish_iter)


def estep_eta_fused(lam0, nu, N, sumtheta, mu, invSigma, K, n_iter: int = 7,
                    cg_iter: int = None, polish_iter: int = None, nu_n_iter: int = None,
                    lam_prev=None, extrap=None):
    """Restart-batched fused η side: lam0/nu/sumtheta (R, D, MK), N (D, M)
    shared by the lanes, mu (R, MK), invSigma (R, MK, MK), K the M topic
    counts (sum(K) = MK ≤ KERNEL_MAX_MK) -> (ζ (R, D, M), ν' (R, D, MK),
    λ' (R, D, MK)). With `lam_prev` (R, D, MK), the previous iteration's λ,
    and `extrap` = c (not None or 0), the λ solve starts at the secant step
    λ + clamp(c·(λ − λ_prev), ±4) (ops/solvers.extrapolated_start), which the
    kernel forms after ζ and ν have read λ; without both it starts at λ and
    the kernel runs exactly as it did before it took `lam_prev`. CPU tensors
    take the plain version; CUDA tensors must be float32 and launch the
    kernel in the layout of `launch_geometry`. The tracer's span
    `kernel.eta_host` covers the call, the launch's return included."""
    t = profiling.begin("kernel.eta_host") if profiling.ON else None
    out = _launch_at(None, lam0, nu, N, sumtheta, mu, invSigma, K, n_iter, cg_iter,
                     polish_iter, nu_n_iter, lam_prev, extrap)
    if t is not None:
        profiling.end(t)
    return out


def _launch_at(geometry, lam0, nu, N, sumtheta, mu, invSigma, K, n_iter: int = 7,
               cg_iter: int = None, polish_iter: int = None, nu_n_iter: int = None,
               lam_prev=None, extrap=None):
    """`estep_eta_fused` with the kernel launched as `geometry` (an
    EtaGeometry; None: `launch_geometry`'s), for measurements and tests.
    Raises ValueError for a geometry the kernel does not take at this MK."""
    if lam0.dim() != 3:
        raise ValueError(f"lam0 must be (R, D, MK), got shape {tuple(lam0.shape)}")
    R, D, MK = lam0.shape
    K = _check_K(K, MK)
    M = len(K)
    if MK > KERNEL_MAX_MK:
        raise ValueError(f"MK={MK} exceeds the η kernel's limit of {KERNEL_MAX_MK} topics")
    if geometry is not None:
        _check_geometry(EtaGeometry(*geometry), MK)
    if not extrap:
        lam_prev = None
    if lam0.device.type == "cpu":
        return estep_eta_fused_plain(lam0, nu, N, sumtheta, mu, invSigma, K, n_iter, cg_iter,
                                     polish_iter, nu_n_iter, lam_prev, extrap)
    if lam0.device.type != "cuda":
        raise ValueError(f"the η kernel runs on CUDA tensors, got {lam0.device}")
    args = (lam0, nu, N, sumtheta, mu, invSigma)
    shapes = ((R, D, MK), (R, D, MK), (D, M), (R, D, MK), (R, MK), (R, MK, MK))
    names = ("lam0", "nu", "N", "sumtheta", "mu", "invSigma")
    if lam_prev is not None:
        args, shapes, names = args + (lam_prev,), shapes + ((R, D, MK),), names + ("lam_prev",)
    for name, t, shape in zip(names, args, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the η kernel takes float32, got {name} as {t.dtype}")
        if t.device != lam0.device:
            raise ValueError(f"{name} is on {t.device}, lam0 on {lam0.device}")
    zeta = torch.empty((R, D, M), dtype=torch.float32, device=lam0.device)
    nu_out = torch.empty_like(lam0, memory_format=torch.contiguous_format)
    lam_out = torch.empty_like(nu_out)
    if R * D == 0:
        return zeta, nu_out, lam_out
    geo = launch_geometry(R, D, MK) if geometry is None else EtaGeometry(*geometry)
    cg_iter, polish_iter, nu_n_iter = _defaults(MK, cg_iter, polish_iter, nu_n_iter)
    _, launch = cuda_function("estep_eta", "estep_eta_launch", _ARGTYPES)
    args = [t.contiguous() for t in args]
    prev_ptr = args[6].data_ptr() if lam_prev is not None else None
    K_host = (ctypes.c_int * M)(*K)
    with torch.cuda.device(lam0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            *(t.data_ptr() for t in args[:6]), prev_ptr, zeta.data_ptr(), nu_out.data_ptr(),
            lam_out.data_ptr(), ctypes.addressof(K_host), M, R, D, MK, int(n_iter),
            cg_iter, polish_iter, nu_n_iter, float(extrap or 0.0), _LAYOUTS[geo.layout], geo.P,
            geo.docs_per_block, stream,
        )
    if rc != 0:
        raise RuntimeError(f"η kernel launch failed with CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return zeta, nu_out, lam_out
