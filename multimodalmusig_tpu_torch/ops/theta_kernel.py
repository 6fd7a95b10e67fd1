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
# The tile layout (K ≤ 8): threads per block, at most (the kernel's
# __launch_bounds__); the documents a block serves, at most; the shared
# memory it may take, at most.
MAX_THREADS = 256
BLOCK_DOCS = 64
MAX_SMEM = 96 * 1024
# The vocabulary items a thread of the tile layout takes (its
# instantiations, csrc/theta_moments.cu, compute exactly K topics a cell).
_ITEMS = 4
# The chunk layout (K 9–128; csrc/theta_moments.cu): blocks a cluster, at
# most; a thread's Z tile (documents, items); the fewest documents a block
# serves once R·D reaches FEW_DOCS (a restart batch), which keeps the
# scratch within R·⌈D/BLOCK_MIN_DOCS⌉·K·V floats; the blocks a call should
# put on the card before it takes fewer documents a block, and the most
# documents a block walks; the documents a staged chunk, at most; a
# block's shared memory, at most (the H100's 227 KB), and the most at which
# two blocks share an SM.
MAX_CLUSTER = 8
Z_DOCS, Z_ITEMS = 4, 4
BLOCK_MIN_DOCS = 32
FEW_DOCS = 560 * 8
FILL_BLOCKS = 66
MAX_BLOCK_DOCS = 512
CHUNK_DOCS = 32
MAX_BLOCK_SMEM = 227 * 1024

# Kernel launches since import (or since a caller last reset it to 0).
LAUNCHES = 0


def _chunk_topics(K):
    """csrc/theta_moments.cu chunk_topics: K padded to KT, a multiple of 4."""
    return -(-K // 4) * 4


def _chunk_row(K):
    """csrc/theta_moments.cu chunk_row: KT, or KT + 4 where KT is an even
    number of float4s: the A and B row stride in floats."""
    kt = _chunk_topics(K)
    return kt if kt // 4 % 2 else kt + 4


def _chunk_tiles(V, threads):
    """The chunk layout's Z tiles (csrc/theta_moments.cu), Z_DOCS × Z_ITEMS
    each: (item groups, document groups)."""
    nvz = -(-V // Z_ITEMS)
    return nvz, threads // nvz


def _smem_bytes(K, groups, rows, td, tv):
    """The tile layout's shared memory (csrc/theta_moments.cu smem_floats):
    logw and the λ rows at a row stride of K rounded up to 4 (plus 4 where
    that is a multiple of 8), and the larger of the two reduction
    scratches."""
    ls = -(-K // 4) * 4
    ls += 4 if ls % 8 == 0 else 0
    docs, vp = rows * td, groups * tv
    return 4 * ((vp + docs) * ls + max(docs * K * (groups + 1), 8 * vp * (rows + 1)))


def _chunk_smem_bytes(V, K, chunk):
    """The chunk layout's shared memory (chunk_smem_floats): B and the
    scatter sums (V rows each), A (chunk rows), two buffers of R (chunk rows
    at a stride of V | 1) and of λ rows (chunk·K), and a flag."""
    kp, kt = _chunk_row(K), _chunk_topics(K)
    return 4 * (V * (kp + kt) + chunk * (kp + 2 * (V | 1) + 2 * K) + 4)


class ThetaGeometry(NamedTuple):
    """The θ kernel's launch for one (R, D, V, K). The tile layout
    (`layout` "tile", K ≤ 8): a thread takes `tile_docs` documents by
    `tile_items` vocabulary items; a block has `item_groups` × `doc_rows`
    threads and serves `docs_per_block` documents of one restart. The chunk
    layout ("chunk", K 9–128): a block of `item_groups` threads (256 or
    512; `doc_rows` 1, `tile_items` 0) walks its `tile_docs` =
    `docs_per_block` documents `chunk_docs` at a time, and its blocks form
    clusters of `cluster`. Both: the grid is `grid` = (blocks per restart,
    R); `scratch` floats hold the partial scatters and `counter` ints the
    arrival count of each restart."""

    tile_docs: int
    tile_items: int
    item_groups: int
    doc_rows: int
    docs_per_block: int
    grid: tuple
    scratch: int
    counter: int
    layout: str = "tile"
    cluster: int = 1
    chunk_docs: int = 0


def _tile_geometry(R, D, V, K):
    """The tile layout (K ≤ 8). Thread (vg, dg) of a block takes items
    v = vg + i·item_groups, i < tile_items, with item_groups = ⌈V /
    tile_items⌉, so neighbouring threads read neighbouring v and V = 96 or
    48 leaves no item slot empty. doc_rows is the most rows, up to D, that
    keep the block within MAX_THREADS and, where it can, a whole number of
    warps; each row takes tile_docs documents, so a block serves up to
    BLOCK_DOCS (V = 96: 24 × 8 threads, 8 documents a row; V = 48: 12 × 16
    threads, 4 a row), fewer where its shared memory would pass MAX_SMEM."""
    tv = _ITEMS
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


def _chunk_geometry(R, D, V, K, n_blocks=None, threads=None, chunk=CHUNK_DOCS):
    """The chunk layout (or `threads`, `n_blocks` and `chunk` as given):
    256 threads a block, 512 where one block takes more than half an SM's
    shared memory; blocks a restart enough that R·blocks reaches
    FILL_BLOCKS and, at 256 threads, none walks more than MAX_BLOCK_DOCS
    documents, as far as the documents allow: at least BLOCK_MIN_DOCS a
    block when R·D ≥ FEW_DOCS, else up to MAX_CLUSTER blocks per
    BLOCK_MIN_DOCS documents and at least one document a block; then whole
    clusters of up to MAX_CLUSTER blocks, never more blocks than that;
    chunks of up to CHUNK_DOCS documents that the Z tiles cover and the
    shared memory holds."""
    if R * D >= FEW_DOCS:
        cap = max(1, D // BLOCK_MIN_DOCS)
    else:
        cap = min(D, MAX_CLUSTER * -(-D // BLOCK_MIN_DOCS))
    if threads is None:
        threads = 256 if _chunk_smem_bytes(V, K, CHUNK_DOCS) <= MAX_BLOCK_SMEM // 2 else 512
    if n_blocks is None:
        n_blocks = -(-FILL_BLOCKS // R)
        if threads == 256:
            n_blocks = max(n_blocks, -(-D // MAX_BLOCK_DOCS))
    want = max(1, min(cap, n_blocks))
    clusters = -(-want // MAX_CLUSTER)
    cluster = want // clusters
    blocks = cluster * clusters
    dpb = -(-D // blocks)
    chunk = min(chunk, dpb, _chunk_tiles(V, threads)[1] * Z_DOCS)
    while _chunk_smem_bytes(V, K, chunk) > MAX_BLOCK_SMEM:
        chunk -= 1
    return ThetaGeometry(tile_docs=dpb, tile_items=0, item_groups=threads, doc_rows=1,
                         docs_per_block=dpb, grid=(blocks, R),
                         scratch=R * clusters * K * V if clusters > 1 else 0, counter=R,
                         layout="chunk", cluster=cluster, chunk_docs=chunk)


@functools.lru_cache(maxsize=None)
def launch_geometry(R: int, D: int, V: int, K: int) -> ThetaGeometry:
    """The θ kernel's geometry: the tile layout at K ≤ 8 (`_tile_geometry`),
    the chunk layout above (`_chunk_geometry`)."""
    return _tile_geometry(R, D, V, K) if K <= 8 else _chunk_geometry(R, D, V, K)


def _candidate_geometries(R: int, D: int, V: int, K: int):
    """The launches the rule weighs for this (R, D, V, K), for measurements
    and tests: at K ≤ 8 the tile layout; above, the chunk layout at the
    rule's blocks a restart, at half and at twice as many, with the other
    block size, and with half the chunk."""
    picked = launch_geometry(R, D, V, K)
    if K <= 8:
        return (picked,)
    blocks, threads = picked.grid[0], picked.item_groups
    return tuple(dict.fromkeys([
        picked, _chunk_geometry(R, D, V, K, max(1, blocks // 2)),
        _chunk_geometry(R, D, V, K, blocks * 2),
        _chunk_geometry(R, D, V, K, blocks, 512 if threads == 256 else 256),
        _chunk_geometry(R, D, V, K, blocks, threads, max(1, picked.chunk_docs // 2))]))


# lam, its two strides; logw, its three strides; X, sumtheta, partial,
# scatter, counter; R, D, V, K; tile docs and items, item groups, document
# rows, blocks per restart, layout (0 tile, 1 chunk), cluster, chunk docs;
# stream
_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
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
    return _launch_at(None, lam_block, logw, X)


def _launch_at(geometry, lam_block, logw, X):
    """`theta_moments_fused` with the kernel launched as `geometry` (a
    ThetaGeometry of `_candidate_geometries`; None: `launch_geometry`'s),
    for measurements and tests."""
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
    geo = launch_geometry(R, D, V, K) if geometry is None else ThetaGeometry(*geometry)
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
            geo.tile_docs, geo.tile_items, geo.item_groups, geo.doc_rows, geo.grid[0],
            int(geo.layout == "chunk"), geo.cluster, geo.chunk_docs, stream,
        )
    if rc != 0:
        raise RuntimeError(f"θ kernel launch failed with CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return sumtheta, scatter
