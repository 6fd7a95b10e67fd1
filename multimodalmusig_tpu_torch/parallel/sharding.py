"""Restart- and data-parallel fitting over several devices, on
torch.distributed.

Counterpart of multimodalmusig_tpu/parallel/sharding.py. The reference's
only parallelism is the restart fan-out of its CLI (`Distributed.pmap` over
restarts, scripts/run_mmctm.jl:99-111), with no communication while the
workers fit; cohort-scale data needs the data-parallel M-step. Here:

  * restart fan-out (`shmap_fit_restarts`, and `devices=` on the family
    fitters of parallel/restarts.py): the lanes go in contiguous slices to
    one process per device (parallel/_ranks.py), each of which runs the
    single-device fit of its slice, kernels included; no rank talks to
    another;
  * data-parallel (`sharded_data_parallel_fit`): each rank holds a
    contiguous slice of the documents (their rows of X, λ, ν, ζ and λ_pre)
    and runs the E-step on it; μ, Σ, Σ⁻¹, γ, E[ln ϕ] and α are replicated,
    and every sum over documents (μ, Σ, the γ scatter, the lls, the final
    ELBO) is all-reduced through the `DocSum` hook of models/ctm_base.py;
  * both at once (`sharded_fit_restarts`): lanes over the rows of a
    ("restart", "data") mesh, documents over its columns, one process group
    per row;
  * vocab-sharded (`sharded_vocab_parallel_fit`, the tensor-parallel
    counterpart): each rank holds a contiguous slice of every modality's
    vocabulary (its columns of X, γ and E[ln ϕ], its rows of logw_pre) and
    runs the θ moments on it; λ, ν, ζ, μ, Σ, Σ⁻¹ and α are replicated, the
    η side runs on every rank from the same bits, and every sum over the
    vocabulary (N, sumθ, γ's row sums, the lls, the final ELBO) is
    all-reduced through the `vocab_reduce` hook of models/ctm_base.py.

A device may appear more than once in a device list or mesh: the ranks then
share the card over gloo (parallel/_ranks.py's backend rule). Results come
back in lane order on the caller's device; the inits are built by the caller
exactly as the single-device fit builds them, so the device list never
changes a lane's init.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models import ctm_base
from ..models import mmctm as mmctm_mod
from ..models.mmctm import MMCTMConfig, MMCTMFitResult, MMCTMState
from . import _ranks
from .restarts import _init_lanes, fit_restarts_from_states

__all__ = [
    "Mesh",
    "DocSum",
    "make_mesh",
    "sharded_fit_from_states",
    "sharded_fit_restarts",
    "shmap_fit_restarts_from_states",
    "shmap_fit_restarts",
    "sharded_data_parallel_fit",
    "sharded_vocab_parallel_fit",
    "dryrun_multichip",
]

# The state fields with a document axis (dim 1), split over the data ranks.
DOC_FIELDS = ("lam", "nu", "zeta", "lam_pre")
# The state fields with a vocabulary axis, split over the vocab ranks: the
# (R, K_m, V_m) tuples on dim 2 and the (R, V_m, K_m) log-weights on dim 1.
VOCAB_FIELDS = {"gamma": 2, "Elnphi": 2, "logw_pre": 1}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_restart, n_data) grid of devices with the axis names
    ("restart", "data"); rank r·n_data + c runs on devices[r][c]."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("restart", "data")

    @property
    def shape(self) -> Dict[str, int]:
        return {"restart": len(self.devices), "data": len(self.devices[0])}

    @property
    def flat(self) -> list:
        return [d for row in self.devices for d in row]


def make_mesh(n_restart: int, n_data: int, devices: Optional[Sequence] = None) -> Mesh:
    """A ("restart", "data") mesh over the first n_restart·n_data of
    `devices` (default: every CUDA card). A device may be named more than
    once, so a one-card machine can hold a split."""
    if n_restart < 1 or n_data < 1:
        raise ValueError(f"a mesh needs at least one row and column, got ({n_restart}, {n_data})")
    devices = [_ranks._device(d) for d in (_ranks.default_devices() if devices is None
                                           else devices)]
    if len(devices) < n_restart * n_data:
        raise ValueError(f"need {n_restart * n_data} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[r * n_data:(r + 1) * n_data]) for r in range(n_restart)))


class DocSum:
    """The data-parallel hook (`reduce`) and the vocab-sharded hook
    (`vocab_reduce`) of models/ctm_base.py for one rank: sums over the ranks
    `group_ranks` (a process group, in rank order) that hold the other
    documents, or the other vocabulary slices, of the same lanes.

    `self(tensors)` sums each tensor over the group. Every rank writes its
    values into its own slot of a zeroed (ranks, n) buffer, the buffer is
    all-reduced (exact in any order: each slot has one non-zero summand),
    and each rank adds the slots in rank order; so every rank gets the same
    bits, and Σ⁻¹, which each rank computes from the reduced Σ, is the same
    on every rank. `agree(done)` gives every rank the first rank's flags.
    Gloo runs on the host, so a gloo group stages CUDA tensors there."""

    def __init__(self, group, group_ranks: Sequence[int], device: torch.device):
        self.group = group
        self.ranks = list(group_ranks)
        self.slot = self.ranks.index(dist.get_rank())
        self.host = dist.get_backend(group) == "gloo" and device.type == "cuda"

    def _staged(self, op, t: torch.Tensor) -> torch.Tensor:
        buf = t.cpu() if self.host else t
        op(buf)
        return buf.to(t.device)

    def __call__(self, tensors):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        slots = flat.new_zeros((len(self.ranks), flat.numel()))
        slots[self.slot] = flat
        slots = self._staged(lambda b: dist.all_reduce(b, group=self.group), slots)
        total = slots[0]
        for i in range(1, len(self.ranks)):
            total = total + slots[i]
        out, at = [], 0
        for t in tensors:
            out.append(total[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def agree(self, done: torch.Tensor) -> torch.Tensor:
        flags = self._staged(lambda b: dist.broadcast(b, self.ranks[0], group=self.group),
                             done.to(torch.uint8))
        return flags.to(torch.bool)


def _doc_rows(D: int, n_data: int):
    """Contiguous, near-equal document ranges for n_data data ranks."""
    if D < n_data:
        raise ValueError(f"{D} documents cannot be split over {n_data} data ranks")
    return np.array_split(np.arange(D), n_data)


def _mesh_rank(rank: _ranks.Rank, n_data: int, state: MMCTMState, X, config: MMCTMConfig,
               maxiter: int, tol: float) -> MMCTMFitResult:
    """A rank of `sharded_fit_from_states` with n_data > 1: its lanes and
    documents, fit with a DocSum over its row's process group (each rank
    creates every row's group, in order, as torch.distributed requires)."""
    state = _ranks.tree_map(lambda t: t.to(rank.device), state)
    rows = [list(range(r, r + n_data)) for r in range(0, rank.size, n_data)]
    groups = [dist.new_group(ranks) for ranks in rows]
    row = rank.index // n_data
    reduce = DocSum(groups[row], rows[row], rank.device)
    X = mmctm_mod.counts_tensors(X, config, rank.device)
    return mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol, reduce=reduce)


def sharded_fit_from_states(mesh: Mesh, state: MMCTMState, X, config: MMCTMConfig,
                            maxiter: int = 1000, tol: float = 1e-4,
                            run_info: Optional[dict] = None) -> MMCTMFitResult:
    """Fit every lane of the batched MMCTM `state` over `mesh`: the lanes,
    padded to a multiple of n_restart by cycling them, in contiguous slices
    over the mesh's rows, and the documents in contiguous slices over its
    columns. With one column this is the restart fan-out
    (`_ranks.fit_lanes` of `restarts.fit_restarts_from_states`, no rank
    talking to another). Returns the batched MMCTMFitResult in lane order
    on the state's device. `run_info`, when a dict, receives the ranks'
    backend, ranks per card, start-up and fit seconds and launches
    (parallel/_ranks.py)."""
    n_restart, n_data = mesh.shape["restart"], mesh.shape["data"]
    X = tuple(torch.as_tensor(x).cpu() for x in X)
    if n_data == 1:
        return _ranks.fit_lanes(fit_restarts_from_states, state, (X, config),
                                dict(maxiter=maxiter, tol=tol), mesh.flat, run_info)
    R, device = ctm_base.lanes_of(state)
    doc_rows = _doc_rows(config.D, n_data)
    rank_args = []
    for lanes in _ranks.lane_slices(state, n_restart):
        for rows in doc_rows:
            rows = torch.as_tensor(rows)
            part = lanes._replace(**{f: getattr(lanes, f).index_select(1, rows)
                                     for f in DOC_FIELDS})
            rank_args.append((n_data, part, tuple(x.index_select(0, rows) for x in X), config,
                              maxiter, tol))
    run = _ranks.run_ranks(_mesh_rank, rank_args, mesh.flat)
    if run_info is not None:
        run_info.update(run.info())
    per_row = []
    for r in range(n_restart):
        parts = run.results[r * n_data:(r + 1) * n_data]
        docs = {f: torch.cat([getattr(p.state, f) for p in parts], dim=1) for f in DOC_FIELDS}
        per_row.append(parts[0]._replace(state=parts[0].state._replace(**docs)))
    return _ranks.join_lanes(per_row, R, device)


def sharded_fit_restarts(mesh: Mesh, seed_or_generator: Union[int, torch.Generator], X,
                         config: MMCTMConfig, alpha, restarts: int, maxiter: int = 1000,
                         tol: float = 1e-4, init_method: str = "random",
                         run_info: Optional[dict] = None) -> MMCTMFitResult:
    """`restarts.fit_restarts` with the lanes split over the mesh's
    "restart" rows and the documents over its "data" columns; within a row
    the document sums are all-reduced. The inits are fit_restarts's on the
    mesh's first device, where the result comes back."""
    _, state = _init_lanes(seed_or_generator, X, config, alpha, restarts, init_method,
                           mesh.devices[0][0])
    return sharded_fit_from_states(mesh, state, X, config, maxiter, tol, run_info)


def shmap_fit_restarts_from_states(state: MMCTMState, X, config: MMCTMConfig,
                                   maxiter: int = 1000, tol: float = 1e-4,
                                   devices: Optional[Sequence] = None,
                                   run_info: Optional[dict] = None) -> MMCTMFitResult:
    """The restart fan-out of a batched initial `state` (one from
    `mmctm.init_with_alpha`, or injected by `interop.state_from_numpy`):
    one rank per device (default: every CUDA card) fits a contiguous slice
    of the lanes with `restarts.fit_restarts_from_states`, uncut; the lanes
    pad to a multiple of the device count by cycling and the padding is
    dropped. Returns the result in lane order on the state's device."""
    devices = _ranks.default_devices() if devices is None else list(devices)
    return sharded_fit_from_states(make_mesh(len(devices), 1, devices), state, X, config,
                                   maxiter, tol, run_info)


def shmap_fit_restarts(seed_or_generator: Union[int, torch.Generator], X, config: MMCTMConfig,
                       alpha, restarts: int, maxiter: int = 1000, tol: float = 1e-4,
                       init_method: str = "random", devices: Optional[Sequence] = None,
                       run_info: Optional[dict] = None) -> MMCTMFitResult:
    """The restart fan-out (the reference CLI's `pmap`, run_mmctm.jl:99-111):
    `restarts` lanes initialized as `restarts.fit_restarts` initializes them
    on the first of `devices` (default: every CUDA card), then
    `shmap_fit_restarts_from_states`. Each rank runs the single-device fit,
    kernels included, on its own slice; the result comes back on the first
    device."""
    devices = _ranks.default_devices() if devices is None else list(devices)
    _, state = _init_lanes(seed_or_generator, X, config, alpha, restarts, init_method,
                           _ranks._device(devices[0]))
    return shmap_fit_restarts_from_states(state, X, config, maxiter, tol, devices, run_info)


def sharded_data_parallel_fit(mesh: Mesh, state: MMCTMState, X, config: MMCTMConfig,
                              maxiter: int = 100, tol: float = 1e-4,
                              run_info: Optional[dict] = None) -> MMCTMFitResult:
    """One fit of every lane of `state` with the documents split over all of
    the mesh's devices (sharding.py:156-190 of the JAX package): each rank
    runs the E-step, kernels included, on its documents, and the M-step's
    sums over documents are all-reduced, so the ranks keep one replicated
    μ, Σ, Σ⁻¹, γ and α and stop at the same iteration. Returns the result
    on the state's device."""
    return sharded_fit_from_states(make_mesh(1, len(mesh.flat), mesh.flat), state, X, config,
                                   maxiter, tol, run_info)


def _vocab_cols(V: Sequence[int], n_vocab: int):
    """Per modality, contiguous near-equal vocabulary ranges for n_vocab ranks."""
    for m, v in enumerate(V):
        if v < n_vocab:
            raise ValueError(f"modality {m} has {v} vocabulary items, which cannot be split "
                             f"over {n_vocab} vocab ranks")
    return [np.array_split(np.arange(v), n_vocab) for v in V]


def _vocab_rank(rank: _ranks.Rank, state: MMCTMState, X, config: MMCTMConfig, maxiter: int,
                tol: float) -> MMCTMFitResult:
    """A rank of `sharded_vocab_parallel_fit`: its vocabulary slice, fit
    with a DocSum over every rank as the vocabulary hook."""
    state = _ranks.tree_map(lambda t: t.to(rank.device), state)
    vocab_reduce = DocSum(dist.group.WORLD, range(rank.size), rank.device)
    X = mmctm_mod.counts_tensors(X, config, rank.device)
    return mmctm_mod.fit(state, X, config, maxiter=maxiter, tol=tol, vocab_reduce=vocab_reduce)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two tensors have one shape, dtype and byte pattern (a NaN
    equals the same NaN)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _join_vocab(parts: Sequence[MMCTMFitResult]) -> MMCTMFitResult:
    """The vocab ranks' results, in rank order, as one: γ, E[ln ϕ] and
    logw_pre joined along V, everything else rank 0's. Raises if any
    replicated field differs in any bit between ranks: every rank ran the
    η side and the M-step on the same reduced sums, so a difference is a
    fault, not rounding."""
    first = parts[0]
    for r, part in enumerate(parts[1:], start=1):
        for name in first._fields:
            if name == "state":
                fields = [(f"state.{f}", getattr(first.state, f), getattr(part.state, f))
                          for f in first.state._fields if f not in VOCAB_FIELDS]
            else:
                fields = [(name, getattr(first, name), getattr(part, name))]
            for label, a, b in fields:
                if not _same_bits(a, b):
                    raise RuntimeError(f"vocab rank {r}'s {label} differs from rank 0's: the "
                                       "replicated state drifted between ranks")
    joined = {f: tuple(torch.cat([getattr(p.state, f)[m] for p in parts], dim=dim)
                       for m in range(len(getattr(first.state, f))))
              for f, dim in VOCAB_FIELDS.items()}
    return first._replace(state=first.state._replace(**joined))


def sharded_vocab_parallel_fit(devices: Sequence, state: MMCTMState, X, config: MMCTMConfig,
                               maxiter: int = 100, tol: float = 1e-4,
                               run_info: Optional[dict] = None) -> MMCTMFitResult:
    """One fit of every lane of `state` with every modality's vocabulary
    split in contiguous slices over `devices`, a flat list (the JAX
    package's flat ("vocab",) mesh, sharding.py:320-342 there): each rank
    runs the θ moments, kernels included, on its columns of X, γ and
    E[ln ϕ], and every rank runs the η side on all documents; the sums over
    the vocabulary are all-reduced (ctm_base's `vocab_reduce`), so the ranks
    keep one replicated λ, ν, ζ, μ, Σ, Σ⁻¹ and α and stop at the same
    iteration. The config stays global. Raises ValueError when a modality
    has fewer items than ranks, and RuntimeError when a replicated field
    differs between ranks. Returns the result on the state's device, with
    γ, E[ln ϕ] and logw_pre joined along V in rank order. `run_info`, when
    a dict, receives the ranks' run (parallel/_ranks.py)."""
    devices = list(devices)
    cols = _vocab_cols(config.V, len(devices))
    _, device = ctm_base.lanes_of(state)
    state = _ranks.tree_map(lambda t: t.cpu(), state)
    X = tuple(torch.as_tensor(x).cpu() for x in X)
    rank_args = []
    for r in range(len(devices)):
        idx = [torch.as_tensor(c[r]) for c in cols]
        part = state._replace(**{f: tuple(t.index_select(dim, i) for t, i in
                                          zip(getattr(state, f), idx))
                                 for f, dim in VOCAB_FIELDS.items()})
        rank_args.append((part, tuple(x.index_select(1, i) for x, i in zip(X, idx)), config,
                          maxiter, tol))
    run = _ranks.run_ranks(_vocab_rank, rank_args, devices)
    if run_info is not None:
        run_info.update(run.info())
    return _ranks.tree_map(lambda t: t.to(device), _join_vocab(run.results))


def dryrun_multichip(n_devices: int) -> None:
    """Run every multi-device path on `n_devices` CPU ranks (gloo) at tiny
    shapes and assert that each agrees with the same fit in one process
    (sharding.py:193-342 of the JAX package): the restart × data mesh, the
    padded restart fan-out, the data-parallel fit, the family fan-out of
    `fit_lda_restarts` and the vocab-sharded fit over the flat device list.
    Float32, 2 CAVI iterations, at the JAX dry run's tolerances."""
    from .restarts import fit_lda_restarts

    devices = ["cpu"] * n_devices
    n_restart = 2 if n_devices % 2 == 0 else 1
    n_data = n_devices // n_restart
    mesh = make_mesh(n_restart, n_data, devices)
    D, V = max(8, 2 * n_devices), max(8, n_devices)
    config = MMCTMConfig(K=(2, 2), V=(V, V), D=D, dtype=torch.float32)
    rng = np.random.default_rng(0)
    X = tuple(torch.as_tensor(rng.integers(0, 5, size=(D, V)), dtype=torch.float32)
              for _ in config.V)
    alpha = [0.1, 0.1]
    R = 2 * n_restart
    close = dict(rtol=2e-4, atol=1e-5)

    def single(state, maxiter=2):
        return fit_restarts_from_states(state, X, config, maxiter=maxiter, tol=1e-4)

    _, state = _init_lanes(0, X, config, alpha, R, "random", "cpu")
    got, want = sharded_fit_from_states(mesh, state, X, config, maxiter=2), single(state)
    assert got.ll.shape == (R, 2) and bool(torch.isfinite(got.ll).all()), got.ll
    torch.testing.assert_close(got.ll, want.ll, **close,
                               msg="restart+data-sharded fit diverged from the one-process fit")
    torch.testing.assert_close(got.state.lam, want.state.lam, rtol=2e-3, atol=1e-4,
                               msg="sharded λ state diverged from the one-process fit")

    # restart fan-out, padded: R + 1 lanes never divide over an even mesh
    _, state = _init_lanes(0, X, config, alpha, R + 1, "random", "cpu")
    got = shmap_fit_restarts_from_states(state, X, config, maxiter=2, devices=devices)
    torch.testing.assert_close(got.ll, single(state).ll, **close,
                               msg="restart fan-out diverged from the one-process fit")

    _, state = _init_lanes(1, X, config, alpha, 1, "random", "cpu")
    want = single(state)
    got = sharded_data_parallel_fit(mesh, state, X, config, maxiter=2)
    torch.testing.assert_close(got.ll, want.ll, **close,
                               msg="data-parallel fit diverged from the one-process fit")

    docs = [[np.array([v + 1, int(X[0][d, v])]) for v in range(V) if X[0][d, v] > 0]
            for d in range(min(D, 8))]
    kw = dict(restarts=2 * n_devices, maxiter=2, tol=1e-4, seed=5, device="cpu")
    plain = fit_lda_restarts(2, 0.1, 0.1, docs, **kw)
    fanned = fit_lda_restarts(2, 0.1, 0.1, docs, devices=devices, **kw)
    torch.testing.assert_close(fanned.restart_result.ll, plain.restart_result.ll, rtol=2e-4,
                               atol=0.0, msg="family fan-out diverged from the one-process fit")

    # the vocabulary over the flat device list, the data-parallel fit's init
    got = sharded_vocab_parallel_fit(devices, state, X, config, maxiter=2)
    torch.testing.assert_close(got.ll, want.ll, **close,
                               msg="vocab-sharded fit diverged from the one-process fit")
