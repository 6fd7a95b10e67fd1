"""Tracing, profiling and numerical-debugging utilities.

Counterpart of multimodalmusig_tpu/utils/profiling.py, in PyTorch's idiom.
The reference's only observability is the per-iteration print of the lls
(src/MMCTM.jl:481-483) and a progress bar around its restart `pmap`
(run_mmctm.jl:101-104). Here, as in the JAX package, every fit result
carries its ll history, iteration counts and convergence flags, and:

  * the program's own spans and counters: the fit loops, the restart
    fitters, the kernels' wrappers and the CLI open named spans (`span`,
    or `begin`/`then`/`end` on the hot path) and add to counters (`count`)
    where the work happens. They record while `tracing()` is on or a
    torch.profiler session records (so a profiled fit traces itself), in
    memory, on `time.time_ns()`, the clock of the profiler's events; read
    them with `totals()` and `spans()`, clear them with `reset()`.
    Recording adds no device→host read and no synchronization, and
    changes no result;
  * `trace(logdir)` records the block with torch.profiler (host and, with a
    card, device activity) and writes a Chrome trace, viewable in Perfetto
    or chrome://tracing, in which the program's spans (and `annotate(name)`,
    the same span) appear above the operations they issued;
  * `debug_nans()` raises at the first operation whose floating output holds
    a NaN, naming the operation (the analogue of `jax_debug_nans`);
    `check_finite(tree)` names the first non-finite leaf of a state or
    result;
  * `Timer` times a block on the host clock and waits for the device first.

The tracer is one per process, as torch.profiler is. The span sites read
`ON`, which each entry point of the program (`cli.main`,
`fit_mmctm_restarts`, `ctm_base.run_cavi`: `entry`) refreshes once, so a
site costs one global read and one branch while nothing records.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["trace", "annotate", "debug_nans", "check_finite", "Timer", "span", "begin",
           "then", "end", "count", "entry", "tracing", "refresh", "totals", "spans", "reset"]

# True while the program records its spans and counters; `refresh` sets it.
ON = False

_tracing = 0         # depth of tracing() blocks
_chrome = 0          # depth of trace() blocks: spans are record_function ranges too
# The spans, one index each, in columns of ints and names: appending to them
# allocates no container, so recording adds no work for the garbage collector.
_names = []          # span name
_starts = []         # start, time.time_ns()
_ends = []           # end, 0 while open
_parents = []        # index of the enclosing span, -1 for none
_entries = []        # id of the entry-point call it belongs to, 0 for none
_open = []           # indices of the open spans, innermost last
_ranges = {}         # span index -> its record_function range, inside trace()
_counts = {}         # counter name -> int
_device_counts = {}  # counter name -> [tensors], summed by totals()
_entry_id = 0        # the id of the newest entry-point call
_entry_depth = 0     # entry-point calls open
_time_ns = time.time_ns


def _profiler_records() -> bool:
    """Whether a torch.profiler session records in this thread."""
    return bool(torch._C._autograd._profiler_enabled()
                or getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


def refresh() -> bool:
    """Set `ON` from `tracing()` and torch.profiler, and return it."""
    global ON
    ON = _tracing > 0 or _profiler_records()
    return ON


def begin(name: str, _at: Optional[int] = None) -> int:
    """Open a span and return its index for `end`. The hot path calls it
    as `t = profiling.begin(name) if profiling.ON else None`."""
    i = len(_names)
    _names.append(name)
    _starts.append(_time_ns() if _at is None else _at)
    _ends.append(0)
    _parents.append(_open[-1] if _open else -1)
    _entries.append(_entry_id if _entry_depth else 0)
    _open.append(i)
    if _chrome:
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        _ranges[i] = rf
    return i


def end(i: int, _at: Optional[int] = None) -> None:
    """Close span `i`, and any span still open inside it."""
    t = _time_ns() if _at is None else _at
    if i >= len(_names) or i not in _open:  # reset, or closed already
        return
    while True:
        j = _open.pop()
        _ends[j] = t
        rf = _ranges.pop(j, None)
        if rf is not None:
            rf.__exit__(None, None, None)
        if j == i:
            return


def then(i: int, name: str) -> int:
    """Close span `i` and open the next phase, `name`, at the same time."""
    t = _time_ns()
    end(i, t)
    return begin(name, t)


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name`. A tensor is kept as it is, on its
    device, and summed only by `totals()`: counting reads nothing back."""
    if isinstance(n, torch.Tensor):
        _device_counts.setdefault(name, []).append(n.detach())
    else:
        _counts[name] = _counts.get(name, 0) + n


class span:
    """`with span(name):` records a named span around the block while `ON`
    is set, and nothing otherwise."""

    __slots__ = ("name", "_i")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._i = begin(self.name) if ON else None
        return self

    def __exit__(self, *exc):
        if self._i is not None:
            end(self._i)
        return False


class entry:
    """An entry point of the program: refreshes `ON`, starts a new entry id
    unless it runs inside another entry point, and, given a name, records a
    span around the block. A span records the id of the outermost entry
    point open when it began (0: none)."""

    __slots__ = ("name", "_i")

    def __init__(self, name: Optional[str] = None):
        self.name = name

    def __enter__(self):
        global _entry_depth, _entry_id
        refresh()
        if _entry_depth == 0:
            _entry_id += 1
        _entry_depth += 1
        self._i = begin(self.name) if ON and self.name else None
        return self

    def __exit__(self, *exc):
        global _entry_depth
        if self._i is not None:
            end(self._i)
        _entry_depth -= 1
        return False


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record the program's spans and counters within the block."""
    global _tracing
    _tracing += 1
    refresh()
    try:
        yield
    finally:
        _tracing -= 1
        refresh()


def reset() -> None:
    """Forget every span and counter recorded (call it outside any span)."""
    global _entry_id
    for column in (_names, _starts, _ends, _parents, _entries):
        column.clear()
    _open.clear()
    _counts.clear()
    _device_counts.clear()
    if _entry_depth == 0:
        _entry_id = 0


def totals() -> dict:
    """{"spans": {name: {"calls", "s", "self_s"}}, "counts": {name: value}}
    over the closed spans and every counter since the last `reset()`. Self
    seconds are a span's duration less its child spans'. Counters kept as
    device tensors are read here."""
    covered = [0] * len(_names)
    for start, stop, parent in zip(_starts, _ends, _parents):
        if stop and parent >= 0:
            covered[parent] += stop - start
    out = {}
    for name, start, stop, child in zip(_names, _starts, _ends, covered):
        if not stop:
            continue
        t = out.setdefault(name, {"calls": 0, "s": 0.0, "self_s": 0.0})
        t["calls"] += 1
        t["s"] += (stop - start) * 1e-9
        t["self_s"] += (stop - start - child) * 1e-9
    counts = dict(_counts)
    for name, tensors in _device_counts.items():
        counts[name] = counts.get(name, 0) + sum(int(t.sum()) for t in tensors)
    return {"spans": out, "counts": counts}


def spans(full: bool = False) -> list:
    """The closed spans as [(start_ns, end_ns, name)] in the order they
    began (the form portbench/trace.summarize takes); with `full`, every
    span as {"name", "start_ns", "end_ns" (None while open), "parent" (an
    index into this list, -1 for none), "entry"}."""
    if full:
        return [{"name": name, "start_ns": start, "end_ns": stop or None, "parent": parent,
                 "entry": ent}
                for name, start, stop, parent, ent in zip(_names, _starts, _ends, _parents,
                                                          _entries)]
    return [(start, stop, name) for name, start, stop in zip(_names, _starts, _ends) if stop]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record the enclosed block with torch.profiler and write it as a
    Chrome trace to `logdir`/trace.json (the directory is created). Records
    the card's activity too when CUDA is available, and the program's spans
    as ranges above the operations they issued. Yields the profiler, so
    the caller can also read `key_averages()`. Once started, the profiler
    slows every later launch in the process: do not time a path after it."""
    global _chrome
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof, tracing():
        _chrome += 1
        try:
            yield prof
        finally:
            _chrome -= 1
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str) -> span:
    """A named span: the program's own, and a range in `trace()`'s Chrome
    trace."""
    return span(name)


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x)


class _NaNCheck(TorchDispatchMode):
    """Checks the floating outputs of every operation dispatched while it
    is active (its own checks run outside it)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"{func} produced {int(torch.isnan(t).sum())} NaN values in an output "
                    f"of shape {tuple(t.shape)}"
                )
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Within the block, raise FloatingPointError at the first PyTorch
    operation that writes a NaN into a floating output, naming it; the
    check ends with the block. Each check reads the output on the host,
    which waits for the device: a debugging aid, slow by design. The
    hand-written kernels write through raw pointers and are not checked;
    the first operation that turns their output into a NaN is."""
    if not enable:
        yield
        return
    with _NaNCheck():
        yield


def _leaves(tree, path: str = ""):
    """(path, leaf) over tuples, lists, NamedTuples and dicts, with the
    JAX package's key paths (jax.tree_util.keystr: ".field", "[i]",
    "['key']")."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, x in zip(tree._fields, tree):
            yield from _leaves(x, f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree, name: str = "state") -> None:
    """Host-side finiteness check over a state, fit result or any nest of
    tuples, NamedTuples, lists and dicts of tensors or arrays. Raises
    FloatingPointError naming the first floating leaf that holds a NaN or
    an infinity, with its count, as the JAX package's check_finite does."""
    for path, leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise FloatingPointError(f"{name}{path}: {bad}/{arr.size} non-finite values")


class Timer:
    """Wall-clock section timer that waits for the device: on exit it
    synchronizes `device` (a device, or a tensor's), or every CUDA device
    in use when none is given, before it reads the clock.

    >>> with Timer("cuda") as t:
    ...     result = fit(...)
    >>> t.elapsed
    """

    def __init__(self, device: Optional[Union[torch.device, str, torch.Tensor]] = None):
        if isinstance(device, torch.Tensor):
            device = device.device
        self.device = None if device is None else torch.device(device)

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device is None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = time.perf_counter() - self.start
        return False
