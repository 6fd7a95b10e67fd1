"""CUDA graphs of the CAVI loop's chains of small PyTorch operations.

A CAVI step on a restart batch issues about a hundred small PyTorch
operations besides its kernels: the M-step, γ, E[ln ϕ] and the lls after
the E-step, and the lane freeze after the step. On the card the host takes
longer to issue them than the card takes to run them. A CUDA graph records
such a chain once and replays it with one launch, on the same data
addresses: the same operations in the same order, so the same bits.

The graphs live for one segment of a fit loop, one `run_cavi_from` call,
in which the number of lanes and the carry's buffers stay put. The loop
opens the segment (`segment`); inside it, the step asks `chain(kind, fn,
like)` for the segment's `Chain` of `fn`. A chain runs eagerly until its
caller marks it warm, which the caller does after one eager call (the
first step of a segment warms cuBLAS, cuSOLVER and the allocator for its
shapes), captures `fn` on its next call and replays it on every call after
that. When the segment ends, its graphs, their buffers and the cuBLAS
workspaces are released, before the fit's ELBO takes its memory.

Graphs are captured on a side stream of their own and replayed on the
current stream, into one memory pool per card that every segment's graphs
share in turn. A graph replays only on the card: on the CPU, and outside a
segment, the program runs its chains eagerly.

The open segment is one per thread, as a capture is: the loop that opens
it and the step it calls share it without a change to the step's
signature, which every model family's step shares.

The tracer (utils/profiling.py) counts `graph.captures.<kind>` and
`graph.replays.<kind>` for each kind of chain (`tail`, `freeze`): a
capture is followed by the capture's own replay, which is not counted
again.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, Optional

import torch

from . import profiling

__all__ = ["Chain", "Segment", "segment", "chain", "leaves"]

# the devices whose fit loops run their chains as graphs
DEVICE_TYPES = ("cuda",)

_local = threading.local()  # .segment: the thread's open Segment, or None
_side_streams = {}          # card index -> the stream graphs are captured on
_anchors = {}               # card index -> the graph that holds its pool of graph memory


def leaves(tree) -> list:
    """The tensors of a (nested) tuple or NamedTuple, in order; None is
    skipped."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, tuple):
            stack.extend(reversed(x))
    return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _side_stream(index: int) -> torch.cuda.Stream:
    if index not in _side_streams:
        _side_streams[index] = torch.cuda.Stream(index)
    return _side_streams[index]


def _pool(index: int):
    """The id of the card's pool of graph memory, which every segment's
    graphs share in turn: a graph released at a segment's end leaves its
    blocks free for the next segment's captures. A one-kernel graph
    captured once and kept holds the pool, which the allocator would
    otherwise give up with its last graph."""
    if index not in _anchors:
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(_side_stream(index)):
            anchor.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=torch.device("cuda", index))
            anchor.capture_end()
        _anchors[index] = anchor
    return _anchors[index].pool()


def _record(fn: Callable, args: tuple, device: torch.device):
    """`fn(*args)` captured as a CUDA graph on `device`, on the card's side
    stream and into its pool, then run once by a replay on the current
    stream: (graph, outputs)."""
    index = device.index
    main = torch.cuda.current_stream(index)
    side = _side_stream(index)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=_pool(index), capture_error_mode="thread_local")
        try:
            out = fn(*args)
        except BaseException:
            with contextlib.suppress(RuntimeError):  # the capture is void: end it
                graph.capture_end()
            raise
        graph.capture_end()
    main.wait_stream(side)
    graph.replay()
    return graph, out


class Chain:
    """`fn`, a chain of PyTorch operations on the card's tensors, run as a
    CUDA graph once warm: the first call after `warm` is set captures
    `fn(*args)` and replays it, each later call replays the graph and
    returns the capture's outputs (the same tensors every call, rewritten by
    each replay).

    The graph reads the capture's input tensors where they lie: they become
    its buffers, so a caller passes at the capture tensors it no longer
    needs (a step's fresh outputs) or that stay put (the carry). A later
    call whose input lies elsewhere has it copied there first, unless the
    capture's input was one of the segment's `pinned` buffers (the carry,
    which the freeze writes in place): the graph cannot follow such an
    input, so that call runs `fn` eagerly."""

    __slots__ = ("kind", "fn", "segment", "warm", "graph", "static", "out", "pinned",
                 "_captures", "_replays")

    def __init__(self, kind: str, fn: Callable, seg: "Segment"):
        self.kind, self.fn, self.segment = kind, fn, seg
        self.warm = False  # set by the caller after its eager warm-up call
        self.graph = None
        self.static = None  # the capture's input tensors
        self.out = None     # the capture's outputs
        self.pinned = None  # per input: whether it is a pinned buffer
        self._captures, self._replays = f"graph.captures.{kind}", f"graph.replays.{kind}"

    def __call__(self, *args):
        xs = leaves(args)
        if self.graph is None:
            return self._capture(args, xs)
        for x, s, pinned in zip(xs, self.static, self.pinned):
            if x is not s and x.data_ptr() != s.data_ptr():
                if pinned:
                    return self.fn(*args)
                s.copy_(x)
        self.graph.replay()
        if profiling.ON:
            profiling.count(self._replays)
        return self.out

    def _capture(self, args, xs):
        self.graph, self.out = _record(self.fn, args, self.segment.device)
        self.static = xs
        self.pinned = [_storage(x) in self.segment.pinned for x in xs]
        if profiling.ON:
            profiling.count(self._captures)
        return self.out

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static = self.out = None


class Segment:
    """The graphs of one segment of a fit loop on one card; `pinned` holds
    the storage addresses of the buffers its chains write in place."""

    def __init__(self, device: torch.device, pinned=()):
        self.device = device
        self.pinned = frozenset(_storage(t) for t in pinned)
        self.chains = {}

    def chain(self, kind: str, fn: Callable) -> Chain:
        c = self.chains.get(fn)
        if c is None:
            c = self.chains[fn] = Chain(kind, fn, self)
        return c

    def release(self) -> None:
        captured = any(c.graph is not None for c in self.chains.values())
        for c in self.chains.values():
            c.release()
        self.chains.clear()
        if captured and self.device.type == "cuda":
            # cuBLAS keeps a workspace for each stream it ran on, the
            # capture stream's made by the first capture: drop them with
            # the graphs that used it, as PyTorch's own graph trees do
            # (the current stream's is made again by its next product)
            torch._C._cuda_clearCublasWorkspaces()


@contextlib.contextmanager
def segment(device, pinned=()) -> Iterator[Optional[Segment]]:
    """Open a segment of a fit loop on `device` for the block: a Segment
    on a CUDA card, None elsewhere. Its graphs are released when the block
    ends."""
    device = torch.device(device)
    if device.type not in DEVICE_TYPES:
        yield None
        return
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    seg = Segment(device, pinned)
    outer = getattr(_local, "segment", None)
    _local.segment = seg
    try:
        yield seg
    finally:
        _local.segment = outer
        seg.release()


def chain(kind: str, fn: Callable, like: torch.Tensor) -> Optional[Chain]:
    """The open segment's chain of `fn` when the segment runs on the card
    of the tensor `like`; None otherwise (no segment open: `fn` runs
    eagerly)."""
    seg = getattr(_local, "segment", None)
    if seg is None or like.device != seg.device:
        return None
    return seg.chain(kind, fn)
