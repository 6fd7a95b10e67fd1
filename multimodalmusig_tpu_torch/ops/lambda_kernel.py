"""The fused λ Newton/PCG solve: CUDA kernel, its wrapper, its plain version.

Counterpart of multimodalmusig_tpu/ops/pallas/lambda_kernel.py. The kernel
(csrc/lambda_newton.cu, which documents its design and bounds) is compiled
by nvcc for sm_90a on first use (native_build.py) and bound through its
plain C interface with ctypes.

Dispatch is by device only: a CPU tensor takes the plain PyTorch version
(`maximize_lambda_restarts_plain`, which is ops/solvers.maximize_lambda at
the kernel's default budgets); a CUDA tensor launches the kernel, or raises
when it cannot be built or launched — there is no fallback. `LAUNCHES`
counts the kernel's launches, so a run can show that its path went through
the kernel. `launch_geometry` picks the kernel's layout from MK and the
number of problems, and the wrapper passes it to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..native_build import cuda_function
from .solvers import CG_ITER_F32_CAP, LAMBDA_POLISH_ITERS, maximize_lambda

__all__ = [
    "maximize_lambda_restarts",
    "maximize_lambda_restarts_plain",
    "maximize_lambda_fused",
    "build",
    "KERNEL_MAX_MK",
    "LAUNCHES",
    "launch_geometry",
]

# The TPU kernel's PALLAS_MAX_MK: one lane per coordinate in a group of at
# most four warps.
KERNEL_MAX_MK = 128

# Kernel launches since import (or since a caller last reset it to 0).
LAUNCHES = 0

# The layouts' reach. At MK ≤ 32 a call of fewer (restart, document)
# problems than FEW_PROBLEMS[P] (P the warp group's lanes) takes the warp
# layout, in blocks of WARP_DOCS[P] problems: there the time is one
# problem's dependency chain, not instruction issue. Above that, a pair of
# threads per problem at MK 17–20 (PCAWG's MK 19), else one thread per
# problem. Thresholds from lambda_bench.py on an H100 (PERF.md §6).
GROUP_MAX_MK = 32
PAIR_MIN_MK, PAIR_MAX_MK = 17, 20
FEW_PROBLEMS = {16: 6144, 32: 2560}
WARP_DOCS = {16: 4, 32: 8}
THREAD_DOCS = 64
# The thread layout's coordinates per thread (P ≥ MK), and the pair
# layout's per thread of a pair (2P ≥ MK): the kernel's instantiations.
THREAD_P = (2, 4, 6, 8, 10, 12, 14, 16, 20, 24, 28, 32)
PAIR_P = 10
# The kernel's layout codes (csrc/lambda_newton.cu).
_LAYOUTS = {"thread": 0, "pair": 1, "warp": 2, "block": 3}

# lam0, nu, Ndivzeta, sumtheta, mu, invSigma, out; R, D, MK, n_iter,
# cg_iter, polish_iter; layout, P, documents per block; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


class LambdaGeometry(NamedTuple):
    """The λ kernel's launch: `layout` "thread" (one thread per (restart,
    document) problem, holding P ≥ MK coordinates), "pair" (two threads per
    problem, P ≥ MK/2 coordinates each), "warp" (a P-lane group per problem
    inside one warp) or "block" (a P-lane group of whole warps);
    `docs_per_block` documents of one restart per block."""

    layout: str
    P: int
    docs_per_block: int


def _check_mk(MK):
    if not 1 <= MK <= KERNEL_MAX_MK:
        raise ValueError(f"MK={MK} is outside the λ kernel's 1..{KERNEL_MAX_MK}")


def _thread_P(MK):
    return min(p for p in THREAD_P if p >= MK)


def _group_P(MK):
    return min(p for p in (16, 32, 64, 128) if p >= MK)


@functools.lru_cache(maxsize=None)
def launch_geometry(R: int, D: int, MK: int) -> LambdaGeometry:
    """MK > 32: a BlockGroup of 64 or 128 lanes per problem, 256 threads a
    block. MK ≤ 32: below FEW_PROBLEMS problems R·D (the single-model
    entry), a warp group of 16 or 32 lanes per problem; else a pair of
    threads per problem at MK 17–20, one thread per problem (P = MK rounded
    up to even, or to 20, 24, 28, 32) at any other MK, 64 documents a
    block."""
    _check_mk(MK)
    if not (R >= 1 and D >= 1):
        raise ValueError(f"R={R} and D={D} must be positive")
    P = _group_P(MK)
    if MK > GROUP_MAX_MK:
        return LambdaGeometry("block", P, 256 // P)
    if R * D < FEW_PROBLEMS[P]:
        return LambdaGeometry("warp", P, WARP_DOCS[P])
    if PAIR_MIN_MK <= MK <= PAIR_MAX_MK:
        return LambdaGeometry("pair", PAIR_P, THREAD_DOCS)
    return LambdaGeometry("thread", _thread_P(MK), THREAD_DOCS)


def _candidate_geometries(MK: int) -> Tuple[LambdaGeometry, ...]:
    """Every layout the kernel can run an MK with, each at its smallest P,
    for measurements and tests: at MK ≤ 32 the thread layout, the pair at
    MK 17–20 (64 documents a block) and the warp layout in blocks of 64 and
    of 256 threads; above, the block layout."""
    _check_mk(MK)
    P = _group_P(MK)
    if MK > GROUP_MAX_MK:
        return (LambdaGeometry("block", P, 256 // P),)
    pair = ((LambdaGeometry("pair", PAIR_P, THREAD_DOCS),)
            if PAIR_MIN_MK <= MK <= PAIR_MAX_MK else ())
    return (LambdaGeometry("thread", _thread_P(MK), THREAD_DOCS), *pair,
            LambdaGeometry("warp", P, 64 // P),
            LambdaGeometry("warp", P, 256 // P))


def _check_geometry(geo: LambdaGeometry, MK: int):
    """Raises ValueError unless the kernel takes `geo` at this MK (the
    rules of csrc/lambda_newton.cu lambda_newton_launch)."""
    layout, P, docs = geo
    ok = {
        "thread": P in THREAD_P and P >= MK and 1 <= docs <= THREAD_DOCS,
        "pair": P == PAIR_P and 2 * P >= MK and docs in (16, 32, 48, 64),
        "warp": P in (16, 32) and P >= MK and docs >= 1 and docs * P % 32 == 0
        and docs * P <= 256,
        "block": P in (64, 128) and P >= MK and docs == 256 // P,
    }.get(layout, False)
    if not ok:
        raise ValueError(f"the λ kernel has no launch {geo} at MK={MK}")


def build() -> str:
    """Compile the kernel (once per source/flag hash) and load it; return
    the library's path. Raises if nvcc is missing or the compile fails."""
    return cuda_function("lambda_newton", "lambda_newton_launch", _ARGTYPES)[0]


def maximize_lambda_restarts_plain(lam0, nu, Ndivzeta, sumtheta, mu, invSigma,
                                   n_iter: int = 7, cg_iter: int = None,
                                   polish_iter: int = None):
    """The plain PyTorch version of the kernel: the same solve at the same
    defaults (cg_iter = min(MK, CG_ITER_F32_CAP), polish LAMBDA_POLISH_ITERS)."""
    MK = lam0.shape[-1]
    return maximize_lambda(
        lam0, nu, Ndivzeta, sumtheta, mu, invSigma, n_iter=n_iter,
        cg_iter=min(MK, CG_ITER_F32_CAP) if cg_iter is None else cg_iter,
        polish_iter=LAMBDA_POLISH_ITERS if polish_iter is None else polish_iter,
    )


def maximize_lambda_restarts(lam0, nu, Ndivzeta, sumtheta, mu, invSigma,
                             n_iter: int = 7, cg_iter: int = None,
                             polish_iter: int = None):
    """Restart-batched fused λ solve: lam0/nu/Ndivzeta/sumtheta (R, D, MK),
    mu (R, MK), invSigma (R, MK, MK) — each restart lane has its own
    Gaussian. MK ≤ KERNEL_MAX_MK. CPU tensors take the plain version; CUDA
    tensors must be float32 and launch the kernel in the layout of
    `launch_geometry`."""
    return _launch_at(None, lam0, nu, Ndivzeta, sumtheta, mu, invSigma,
                      n_iter, cg_iter, polish_iter)


def _launch_at(geometry, lam0, nu, Ndivzeta, sumtheta, mu, invSigma,
               n_iter: int = 7, cg_iter: int = None, polish_iter: int = None):
    """`maximize_lambda_restarts` with the kernel launched as `geometry`
    (a LambdaGeometry; None: `launch_geometry`'s), for measurements and
    tests. Raises ValueError for a geometry the kernel does not take at
    this MK."""
    if lam0.dim() != 3:
        raise ValueError(f"lam0 must be (R, D, MK), got shape {tuple(lam0.shape)}")
    R, D, MK = lam0.shape
    if MK > KERNEL_MAX_MK:
        raise ValueError(
            f"MK={MK} exceeds the λ kernel's limit of {KERNEL_MAX_MK} topics"
        )
    if geometry is not None:
        _check_geometry(LambdaGeometry(*geometry), MK)
    if lam0.device.type == "cpu":
        return maximize_lambda_restarts_plain(
            lam0, nu, Ndivzeta, sumtheta, mu, invSigma, n_iter, cg_iter, polish_iter
        )
    if lam0.device.type != "cuda":
        raise ValueError(f"the λ kernel runs on CUDA tensors, got {lam0.device}")
    args = (lam0, nu, Ndivzeta, sumtheta, mu, invSigma)
    shapes = ((R, D, MK),) * 4 + ((R, MK), (R, MK, MK))
    for name, t, shape in zip(("lam0", "nu", "Ndivzeta", "sumtheta", "mu", "invSigma"),
                              args, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the λ kernel takes float32, got {name} as {t.dtype}")
        if t.device != lam0.device:
            raise ValueError(f"{name} is on {t.device}, lam0 on {lam0.device}")
    if R * D == 0:
        return torch.empty_like(lam0)
    geo = launch_geometry(R, D, MK) if geometry is None else LambdaGeometry(*geometry)
    if cg_iter is None:
        cg_iter = min(MK, CG_ITER_F32_CAP)
    if polish_iter is None:
        polish_iter = LAMBDA_POLISH_ITERS
    _, launch = cuda_function("lambda_newton", "lambda_newton_launch", _ARGTYPES)
    args = [t.contiguous() for t in args]
    out = torch.empty_like(args[0])
    with torch.cuda.device(lam0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            *(t.data_ptr() for t in args), out.data_ptr(),
            R, D, MK, int(n_iter), int(cg_iter), int(polish_iter),
            _LAYOUTS[geo.layout], geo.P, geo.docs_per_block, stream,
        )
    if rc != 0:
        raise RuntimeError(f"λ kernel launch failed with CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def maximize_lambda_fused(lam0, nu, Ndivzeta, sumtheta, mu, invSigma,
                          n_iter: int = 7, cg_iter: int = None,
                          polish_iter: int = None):
    """The single-model entry: lam0/nu/Ndivzeta/sumtheta (B, MK) with one
    shared mu (MK,) and invSigma (MK, MK) — the restart kernel at R = 1."""
    return maximize_lambda_restarts(
        lam0[None], nu[None], Ndivzeta[None], sumtheta[None], mu[None],
        invSigma[None], n_iter, cg_iter, polish_iter,
    )[0]
