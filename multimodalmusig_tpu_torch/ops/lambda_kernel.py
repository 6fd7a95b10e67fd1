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
the kernel.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from ..native_build import build_shared_library
from .solvers import CG_ITER_F32_CAP, LAMBDA_POLISH_ITERS, maximize_lambda

__all__ = [
    "maximize_lambda_restarts",
    "maximize_lambda_restarts_plain",
    "maximize_lambda_fused",
    "build",
    "KERNEL_MAX_MK",
    "LAUNCHES",
]

# One lane per coordinate in a group of at most one warp.
KERNEL_MAX_MK = 32

# Kernel launches since import (or since a caller last reset it to 0).
LAUNCHES = 0

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "lambda_newton.cu"
)
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_lock = threading.Lock()
_lib = None
_lib_path = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def build() -> str:
    """Compile the kernel (once per source/flag hash) and load it; return
    the library's path. Raises if nvcc is missing or the compile fails."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build_shared_library("lambda_newton", [_SRC], [_nvcc(), *_NVCC_FLAGS])
            lib = ctypes.CDLL(path)
            lib.lambda_newton_launch.restype = ctypes.c_int
            lib.lambda_newton_launch.argtypes = (
                [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            )
            _lib, _lib_path = lib, path
        return _lib_path


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
    tensors must be float32 and launch the kernel."""
    if lam0.dim() != 3:
        raise ValueError(f"lam0 must be (R, D, MK), got shape {tuple(lam0.shape)}")
    R, D, MK = lam0.shape
    if MK > KERNEL_MAX_MK:
        raise ValueError(
            f"MK={MK} exceeds the λ kernel's limit of {KERNEL_MAX_MK} topics "
            "(one warp lane per coordinate)"
        )
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
    if cg_iter is None:
        cg_iter = min(MK, CG_ITER_F32_CAP)
    if polish_iter is None:
        polish_iter = LAMBDA_POLISH_ITERS
    build()
    args = [t.contiguous() for t in args]
    out = torch.empty_like(args[0])
    with torch.cuda.device(lam0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib.lambda_newton_launch(
            *(t.data_ptr() for t in args), out.data_ptr(),
            R, D, MK, int(n_iter), int(cg_iter), int(polish_iter), stream,
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
