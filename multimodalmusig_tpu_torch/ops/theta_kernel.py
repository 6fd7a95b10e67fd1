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
launched. `LAUNCHES` counts the wrapper's launches, one kernel each.
`launch_geometry` picks the kernel's tile, grid and vocabulary mapping, and
the wrapper passes them to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..native_build import cuda_function

__all__ = [
    "theta_moments_fused",
    "theta_moments_fused_plain",
    "build",
    "THETA_MAX_V",
    "THETA_MAX_K",
    "LAUNCHES",
    "ThetaGeometry",
    "launch_geometry",
]

# The TPU kernel's limits (one 128-wide lane tile for V, K ≤ 128).
THETA_MAX_V = 128
THETA_MAX_K = 128
# Threads per block, at most (the kernel's __launch_bounds__); the documents
# a block serves, at most; the shared memory it may take, at most (two
# blocks an SM at the largest K).
MAX_THREADS = 256
BLOCK_DOCS = 64
MAX_SMEM = 96 * 1024
# (K bound, vocabulary items of a thread) by K: the kernel's instantiations
# (csrc/theta_moments.cu). A cell computes K topics for K ≤ 8, else the K
# bound (the padding topics at -inf).
_ITEMS = ((8, 4), (16, 2), (32, 1), (64, 1), (128, 1))

# Kernel launches since import (or since a caller last reset it to 0).
LAUNCHES = 0


def _smem_bytes(K, groups, rows, td, tv):
    """The kernel's shared memory (csrc/theta_moments.cu smem_floats): logw
    and the λ rows at a row stride of KT rounded up to 4 (plus 4 where that
    is a multiple of 8), and the larger of the two reduction scratches."""
    kt = K if K <= 8 else next(kmax for kmax, _ in _ITEMS if K <= kmax)
    ls = -(-kt // 4) * 4
    ls += 4 if ls % 8 == 0 else 0
    docs, vp = rows * td, groups * tv
    return 4 * ((vp + docs) * ls + max(docs * kt * (groups + 1), 8 * vp * (rows + 1)))


class ThetaGeometry(NamedTuple):
    """The θ kernel's launch for one (R, D, V, K): a thread takes
    `tile_docs` documents by `tile_items` vocabulary items; a block has
    `item_groups` × `doc_rows` threads and serves `docs_per_block`
    documents of one restart; the grid is `grid` = (blocks per restart,
    R); `scratch` floats hold the blocks' partial scatters and `counter`
    ints the arrival count of each restart."""

    tile_docs: int
    tile_items: int
    item_groups: int
    doc_rows: int
    docs_per_block: int
    grid: tuple
    scratch: int
    counter: int


@functools.lru_cache(maxsize=None)
def launch_geometry(R: int, D: int, V: int, K: int) -> ThetaGeometry:
    """The θ kernel's geometry. Thread (vg, dg) of a block takes items
    v = vg + i·item_groups, i < tile_items, with item_groups = ⌈V /
    tile_items⌉, so neighbouring threads read neighbouring v and V = 96 or
    48 leaves no item slot empty. doc_rows is the most rows, up to D, that
    keep the block within MAX_THREADS and, where it can, a whole number of
    warps; each row takes tile_docs documents, so a block serves up to
    BLOCK_DOCS (V = 96: 24 × 8 threads, 8 documents a row; V = 48: 12 × 16
    threads, 4 a row), fewer where its shared memory would pass MAX_SMEM."""
    tv = next(tv for kmax, tv in _ITEMS if K <= kmax)
    groups = -(-V // tv)
    rows = max(1, min(MAX_THREADS // groups, D))
    whole = [n for n in range(rows, 0, -1) if groups * n % 32 == 0]
    rows = whole[0] if whole else rows
    td = max(1, min(BLOCK_DOCS // rows, -(-D // rows)))
    while td > 1 and _smem_bytes(K, groups, rows, td, tv) > MAX_SMEM:
        td -= 1
    docs = rows * td
    blocks = -(-D // docs)
    return ThetaGeometry(tile_docs=td, tile_items=tv, item_groups=groups, doc_rows=rows,
                         docs_per_block=docs, grid=(blocks, R), scratch=R * blocks * K * V,
                         counter=R)


# lam, its two strides; logw, its three strides; X, sumtheta, partial,
# scatter, counter; R, D, V, K; tile docs and items, item groups, document
# rows, blocks per restart; stream
_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
)

# The arrival counters of each device, all 0 between launches (the kernel's
# last block of each restart resets its own): allocated once, grown with R.
_counters = {}


def _counter(device, n):
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


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
    geo = launch_geometry(R, D, V, K)
    device = lam_block.device
    sumtheta = torch.empty((R, D, K), dtype=torch.float32, device=device)
    partial = torch.empty(geo.scratch, dtype=torch.float32, device=device)
    scatter = torch.empty((R, K, V), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        counter = _counter(device, geo.counter)
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(
            lam_block.data_ptr(), lam_block.stride(0), lam_block.stride(1),
            logw.data_ptr(), *logw.stride(), X.data_ptr(), sumtheta.data_ptr(),
            partial.data_ptr(), scatter.data_ptr(), counter.data_ptr(), R, D, V, K,
            geo.tile_docs, geo.tile_items, geo.item_groups, geo.doc_rows, geo.grid[0], stream,
        )
    if rc != 0:
        raise RuntimeError(f"θ kernel launch failed with CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return sumtheta, scatter
