"""Tracing, profiling and numerical-debugging utilities.

Counterpart of multimodalmusig_tpu/utils/profiling.py, in PyTorch's idiom.
The reference's only observability is the per-iteration print of the lls
(src/MMCTM.jl:481-483) and a progress bar around its restart `pmap`
(run_mmctm.jl:101-104). Here, as in the JAX package, every fit result
carries its ll history, iteration counts and convergence flags, and:

  * `trace(logdir)` records the block with torch.profiler (host and, with a
    card, device activity) and writes a Chrome trace, viewable in Perfetto
    or chrome://tracing; `annotate(name)` names a span in it;
  * `debug_nans()` raises at the first operation whose floating output holds
    a NaN, naming the operation (the analogue of `jax_debug_nans`);
    `check_finite(tree)` names the first non-finite leaf of a state or
    result;
  * `Timer` times a block on the host clock and waits for the device first.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["trace", "annotate", "debug_nans", "check_finite", "Timer"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record the enclosed block with torch.profiler and write it as a
    Chrome trace to `logdir`/trace.json (the directory is created). Records
    the card's activity too when CUDA is available. Yields the profiler, so
    the caller can also read `key_averages()`. Once started, the profiler
    slows every later launch in the process: do not time a path after it."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named span in the profiler's trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


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
