"""The fused θ moments: CUDA kernel, its wrapper, its plain version.

Counterpart of tools/pallas_experiments/theta_kernel.py. For one modality
and every restart lane it computes sumθ[r,d,k] = Σ_v X[d,v]·θ[r,d,v,k] and
scatter[r,k,v] = Σ_d X[d,v]·θ[r,d,v,k], with θ = softmax_k(λ_block + logw)
taken with the joint max of each (d, v) cell, and never stores θ. The kernel
(csrc/theta_moments.cu, which documents its design and bounds) is compiled
by nvcc for sm_90a on first use (native_build.py) and bound through its
plain C interface with ctypes.

Dispatch is by device only, as in ops/lambda_kernel.py: a CPU tensor takes
the plain PyTorch version (`theta_moments_fused_plain`, which materializes
θ); a CUDA tensor launches the kernel, or raises when it cannot be built or
launched. `LAUNCHES` counts the wrapper's launches (each runs the kernel's
two passes).
"""

from __future__ import annotations

import ctypes

import torch

from ..native_build import cuda_function

__all__ = [
    "theta_moments_fused",
    "theta_moments_fused_plain",
    "build",
    "THETA_MAX_V",
    "THETA_MAX_K",
    "LAUNCHES",
]

# The TPU kernel's limits (one 128-wide lane tile for V, K ≤ 128).
THETA_MAX_V = 128
THETA_MAX_K = 128
# Documents per block of the kernel's first pass; the second pass adds the
# ⌈D / TILE_DOCS⌉ partial scatters of a restart in tile order.
TILE_DOCS = 32

# Kernel launches since import (or since a caller last reset it to 0).
LAUNCHES = 0

# lam, its two strides; logw, its three strides; X, sumtheta, partial,
# scatter; R, D, V, K, tile; stream
_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
)


def build() -> str:
    """Compile the kernel (once per source/flag hash) and load it; return
    the library's path. Raises if nvcc is missing or the compile fails."""
    return cuda_function("theta_moments", "theta_moments_launch", _ARGTYPES)[0]


def theta_moments_fused_plain(lam_block, logw, X):
    """The plain PyTorch version: θ materialized with torch.softmax, then
    both contractions. lam_block (R, D, K), logw (R, V, K), X (D, V) ->
    (sumθ (R, D, K), scatter (R, K, V))."""
    theta = torch.softmax(lam_block[:, :, None, :] + logw[:, None, :, :], dim=-1)
    return (torch.einsum("dv,rdvk->rdk", X, theta), torch.einsum("dv,rdvk->rkv", X, theta))


def theta_moments_fused(lam_block, logw, X):
    """One modality's θ moments for every restart lane: lam_block (R, D, K)
    and logw (R, V, K), either of them a strided view (the block of the full
    λ, E[ln ϕ]ᵀ), and X (D, V) shared by the lanes -> (sumθ (R, D, K),
    scatter (R, K, V)). V ≤ THETA_MAX_V and K ≤ THETA_MAX_K. CPU tensors
    take the plain version; CUDA tensors must be float32 and launch the
    kernel."""
    if lam_block.dim() != 3:
        raise ValueError(f"lam_block must be (R, D, K), got shape {tuple(lam_block.shape)}")
    R, D, K = lam_block.shape
    V = X.shape[-1]
    if V > THETA_MAX_V or K > THETA_MAX_K:
        raise ValueError(
            f"(V, K)=({V}, {K}) exceeds the θ kernel's limits "
            f"({THETA_MAX_V}, {THETA_MAX_K})"
        )
    if lam_block.device.type == "cpu":
        return theta_moments_fused_plain(lam_block, logw, X)
    if lam_block.device.type != "cuda":
        raise ValueError(f"the θ kernel runs on CUDA tensors, got {lam_block.device}")
    for name, t, shape in (("lam_block", lam_block, (R, D, K)), ("logw", logw, (R, V, K)),
                           ("X", X, (D, V))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"the θ kernel takes float32, got {name} as {t.dtype}")
        if t.device != lam_block.device:
            raise ValueError(f"{name} is on {t.device}, lam_block on {lam_block.device}")
    if lam_block.stride(-1) != 1:
        lam_block = lam_block.contiguous()
    X = X.contiguous()
    _, launch = cuda_function("theta_moments", "theta_moments_launch", _ARGTYPES)
    n_tiles = -(-D // TILE_DOCS)
    sumtheta = torch.empty((R, D, K), dtype=torch.float32, device=lam_block.device)
    partial = torch.empty((R, n_tiles, K, V), dtype=torch.float32, device=lam_block.device)
    scatter = torch.empty((R, K, V), dtype=torch.float32, device=lam_block.device)
    with torch.cuda.device(lam_block.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            lam_block.data_ptr(), lam_block.stride(0), lam_block.stride(1),
            logw.data_ptr(), *logw.stride(), X.data_ptr(), sumtheta.data_ptr(),
            partial.data_ptr(), scatter.data_ptr(), R, D, V, K, TILE_DOCS, stream,
        )
    if rc != 0:
        raise RuntimeError(f"θ kernel launch failed with CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return sumtheta, scatter
