"""The per-modality mixture log-likelihoods: CUDA kernel, its wrapper, its
plain version.

Replaces no TPU kernel (the JAX package leaves this sum to XLA). For every
restart lane r and modality m it computes the sum that
models/mmctm.py `modality_loglikelihoods` divides by the counts,

    ll[r, m] = Σ_d Σ_v X_m[d,v]·log(Σ_k props_m[r,d,k]·ϕ_m[r,k,v]),

with ops/special.py `safe_xlogy`'s zero-count convention, and never stores
the (R, D, V_m) mixture that the plain version forms. The kernel
(csrc/mixture_ll.cu, which documents its design and bounds) is compiled by
nvcc for sm_90a on first use (native_build.py) and bound through its plain
C interface with ctypes.

`mixture_lls` takes CUDA float32 tensors alone and raises on anything else:
which calls reach it, and which take the plain PyTorch version
(`mixture_lls_plain`), is `models/ctm_base._ll_route`'s rule alone.
`LAUNCHES` counts the wrapper's calls, eager calls and graph captures; one
call covers every modality with two device kernels (the partial sums, then
their sum), and a CUDA graph's replays launch them again without a call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..native_build import cuda_function
from .special import safe_xlogy

__all__ = [
    "mixture_lls",
    "mixture_lls_plain",
    "build",
    "LL_MAX_M",
    "LL_MAX_K",
    "LL_MAX_V",
    "LAUNCHES",
    "LLGeometry",
    "launch_geometry",
]

# The kernel's limits: modalities a call, and topics and items of a
# modality (a block stages one modality's ϕ, K × V, in shared memory; the
# θ kernel's limits).
LL_MAX_M = 16
LL_MAX_K = 128
LL_MAX_V = 128
# The documents a block serves, at most (a multiple of the 4 a warp takes
# at a time).
MAX_BLOCK_DOCS = 128

# The wrapper's calls since import (or since a caller last reset it to 0).
LAUNCHES = 0


class LLGeometry(NamedTuple):
    """The kernel's launch for one (R, D, M): a block serves
    `docs_per_block` documents (a multiple of 4) of one restart lane and
    one modality; the grid is `grid` = (R, document blocks, M)."""

    docs_per_block: int
    grid: tuple


@functools.lru_cache(maxsize=None)
def launch_geometry(R: int, D: int, M: int) -> LLGeometry:
    """The fewest document blocks of at most MAX_BLOCK_DOCS documents,
    their documents spread evenly (rounded up to a multiple of 4)."""
    blocks = -(-D // MAX_BLOCK_DOCS)
    docs = -(-(-(-D // blocks)) // 4) * 4
    return LLGeometry(docs_per_block=docs, grid=(R, -(-D // docs), M))


# props, phi, X (host arrays of device addresses); K, V (host int arrays);
# M, R, D, docs a block; partial, out; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)


def build() -> str:
    """Compile the kernel (once per source/flag hash) and load it; return
    the library's path. Raises if nvcc is missing or the compile fails."""
    return cuda_function("mixture_ll", "mixture_ll_launch", _ARGTYPES)[0]


def mixture_lls_plain(X, props, phi) -> list:
    """The plain PyTorch version, which stores each (R, D, V_m) mixture:
    the M sums Σ_d Σ_v X_m·log(props_m @ ϕ_m), each (R,)."""
    return [safe_xlogy(X[m], props[m] @ phi[m]).sum(dim=(-2, -1)) for m in range(len(X))]


def mixture_lls(X, props, phi) -> torch.Tensor:
    """(R, M) sums Σ_d Σ_v X_m[d,v]·log(Σ_k props_m[r,d,k]·ϕ_m[r,k,v]) for
    X (D, V_m) shared by the lanes, props (R, D, K_m) and ϕ (R, K_m, V_m),
    one of each a modality: CUDA float32 tensors on one card, with
    M ≤ LL_MAX_M, K_m ≤ LL_MAX_K and V_m ≤ LL_MAX_V. Raises on anything
    else; `ctm_base._ll_route` sends every other call to the plain
    version."""
    M = len(X)
    if M < 1 or len(props) != M or len(phi) != M:
        raise ValueError(f"need one X, props and ϕ a modality, got {M}, {len(props)}, "
                         f"{len(phi)}")
    if props[0].dim() != 3:
        raise ValueError(f"props must be (R, D, K), got shape {tuple(props[0].shape)}")
    R, D = props[0].shape[:2]
    for m in range(M):
        V, K = X[m].shape[-1], props[m].shape[-1]
        for name, t, shape in (("X", X[m], (D, V)), ("props", props[m], (R, D, K)),
                               ("phi", phi[m], (R, K, V))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name}[{m}] must have shape {shape}, got {tuple(t.shape)}")
    device = props[0].device
    if M > LL_MAX_M:
        raise ValueError(f"M={M} exceeds the ll kernel's limit of {LL_MAX_M} modalities")
    for m in range(M):
        K, V = props[m].shape[-1], X[m].shape[-1]
        if K > LL_MAX_K or V > LL_MAX_V:
            raise ValueError(f"(K, V)=({K}, {V}) of modality {m} exceeds the ll kernel's "
                             f"limits ({LL_MAX_K}, {LL_MAX_V})")
        for name, t in (("X", X[m]), ("props", props[m]), ("phi", phi[m])):
            if t.dtype != torch.float32:
                raise TypeError(f"the ll kernel takes float32, got {name}[{m}] as {t.dtype}")
            if t.device != device:
                raise ValueError(f"{name}[{m}] is on {t.device}, props[0] on {device}")
    if device.type != "cuda":
        raise ValueError(f"the ll kernel runs on CUDA tensors, got {device}")
    out = torch.empty((R, M), dtype=torch.float32, device=device)
    if R * D == 0:
        return out.zero_()
    geo = launch_geometry(R, D, M)
    partial = torch.empty(M * R * geo.grid[1], dtype=torch.float64, device=device)
    tensors = [t.contiguous() for t in (*X, *props, *phi)]  # kept alive through the launch
    addrs = [(ctypes.c_uint64 * M)(*(t.data_ptr() for t in tensors[i * M:(i + 1) * M]))
             for i in range(3)]
    Ks = (ctypes.c_int * M)(*(p.shape[-1] for p in props))
    Vs = (ctypes.c_int * M)(*(x.shape[-1] for x in X))
    _, launch = cuda_function("mixture_ll", "mixture_ll_launch", _ARGTYPES)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(ctypes.addressof(addrs[1]), ctypes.addressof(addrs[2]),
                    ctypes.addressof(addrs[0]), ctypes.addressof(Ks), ctypes.addressof(Vs), M,
                    R, D, geo.docs_per_block, partial.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ll kernel launch failed with CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
