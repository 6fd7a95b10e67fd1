"""One process per device: the port's counterpart of what `shard_map` does
for the JAX package (its parallel/sharding.py), placing one program on each
device.

`run_ranks(fn, rank_args, devices)` starts one process per entry of
`devices` with multiprocessing's spawn start method (a rank starts from a
fresh interpreter and inherits no CUDA context), joins them into one
torch.distributed process group through a TCP store that the calling
process hosts on localhost, calls `fn(rank, *rank_args[i])` in rank i, and
gives back the ranks' return values in rank order, with each rank's kernel
launches and the run's timings. `fit_lanes` fans the lanes of a batched
state out over the devices with it.

The backend is NCCL when every entry is a distinct CUDA card, and gloo
otherwise: on the CPU, and for ranks that share a card (NCCL takes one rank
per card). Processes, not threads: a CAVI step below a few hundred lanes
costs the host's dispatch, which threads sharing one interpreter lock would
serialize. A CPU rank runs on one thread; a CUDA rank sets its card and
loads the kernels before the clock starts, which the calling process has
built first (one nvcc per kernel, started together) so that the ranks do
not each compile them. Inputs and results cross the
process boundary as CPU tensors serialized with torch.save: no CUDA tensor
is pickled.

Nothing is caught and carried on. A rank that raises (no card, a kernel
that fails to build or launch) sends its traceback and the call raises it;
a rank that dies without one makes the call raise; a call that outlasts
TIMEOUT_S raises TimeoutError. Every rank still running is then killed.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import multiprocessing
import os
import queue as queue_mod
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models import ctm_base
from ..ops import estep_kernel, lambda_kernel, theta_kernel

__all__ = ["Rank", "RanksRun", "TIMEOUT_S", "backend_for", "default_devices", "run_ranks",
           "tree_map", "lane_slices", "join_lanes", "fit_lanes"]

# Seconds a run_ranks call may take, start-up included; also the process
# group's timeout for one collective.
TIMEOUT_S = 3600.0

# The kernel wrappers whose launches each rank counts, under chip_smoke.py's names.
KERNELS = {"estep_eta": estep_kernel, "lambda_newton": lambda_kernel,
           "theta_moments": theta_kernel}


@dataclasses.dataclass(frozen=True)
class Rank:
    """A rank's place: its index among `size` ranks, its device and the
    process group's backend."""

    index: int
    size: int
    device: torch.device
    backend: str


@dataclasses.dataclass(frozen=True)
class RanksRun:
    """What `run_ranks` gives back. `startup_s`: from the first spawn until
    the last rank is ready; `startup_split`, each part the largest over the
    ranks: "imports" (from the spawn through the interpreter and its
    imports), "device" (CUDA context, cuBLAS and cuSOLVER handles, kernel
    load) and "group" (the process group and the barrier that starts the
    clock, the wait for slower ranks included); `fit_s`: from then until the last rank's `fn`
    returned (CUDA ranks synchronize first); `launches`: each rank's kernel
    launches inside `fn`."""

    results: list
    launches: List[dict]
    backend: str
    ranks_per_device: int
    startup_s: float
    startup_split: dict
    fit_s: float

    def info(self) -> dict:
        return {"backend": self.backend, "ranks": len(self.results),
                "ranks_per_device": self.ranks_per_device, "startup_s": self.startup_s,
                "startup_split": self.startup_split, "fit_s": self.fit_s,
                "launches": self.launches}


def _device(d) -> torch.device:
    """`d` as a torch.device, a CUDA device with its index ("cuda" is card 0)."""
    d = torch.device(d)
    return torch.device("cuda", d.index or 0) if d.type == "cuda" else d


def default_devices() -> List[torch.device]:
    """Every CUDA card; raises without one."""
    ctm_base.check_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def backend_for(devices: Sequence) -> str:
    """"nccl" when every device is a distinct CUDA card, else "gloo"."""
    devices = [_device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def tree_map(fn: Callable, tree):
    """`fn` on every tensor of a (nested) tuple or NamedTuple; anything else
    passes through."""
    if isinstance(tree, tuple):
        parts = [tree_map(fn, x) for x in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _cpu(tree):
    return tree_map(lambda t: t.detach().cpu(), tree)


def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes):
    # the bytes come from this module's _dumps, in this process or a rank
    return torch.load(io.BytesIO(data), weights_only=False)


def _barrier(backend: str, device: torch.device):
    if backend == "nccl":
        dist.barrier(device_ids=[device.index])
    else:
        dist.barrier()


def _warm(device: torch.device):
    """The CUDA context and the cuBLAS and cuSOLVER handles, which a fit's
    first product and Cholesky factorization would otherwise create."""
    a = torch.eye(2, device=device)
    torch.linalg.cholesky_ex(a @ a)
    torch.linalg.solve_triangular(a, a, upper=False)
    torch.cuda.synchronize(device)


def _rank_main(index: int, devices, backend: str, port: int, timeout: float, payload: bytes,
               results):
    """A rank's process: set up its device and the process group, run the
    function, send (index, "ok", its result, launches and clock) or
    (index, "error", the traceback)."""
    t_enter = time.monotonic()
    try:
        device = devices[index]
        if device.type == "cuda":
            ctm_base.check_device(device)
            torch.cuda.set_device(device)
            _warm(device)
            for kernel in KERNELS.values():
                kernel.build()
        else:
            torch.set_num_threads(1)
        t_device = time.monotonic()
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank runs on this host
        wait = datetime.timedelta(seconds=timeout)
        store = dist.TCPStore("127.0.0.1", port, len(devices), False, timeout=wait)
        dist.init_process_group(backend, store=store, rank=index, world_size=len(devices),
                                timeout=wait)
        fn, args = _loads(payload)
        for kernel in KERNELS.values():
            kernel.LAUNCHES = 0
        _barrier(backend, device)
        t0 = time.monotonic()
        out = fn(Rank(index, len(devices), device, backend), *args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.monotonic()
        launches = {name: kernel.LAUNCHES for name, kernel in KERNELS.items()}
        results.put((index, "ok", _dumps((_cpu(out), launches, (t_enter, t_device, t0, t1)))))
        dist.destroy_process_group()
    except BaseException:
        results.put((index, "error", traceback.format_exc()))
        raise


def _collect(procs, results, devices, deadline: float) -> dict:
    """Each rank's message, by rank index; raises on a rank's error, on a
    rank that exited without a message, and at the deadline."""
    got = {}
    while len(got) < len(procs):
        try:
            msg = results.get(timeout=0.2)
        except queue_mod.Empty:
            dead = [i for i, p in enumerate(procs) if i not in got and p.exitcode is not None]
            if dead:
                try:  # a rank puts its message before it exits
                    msg = results.get(timeout=5.0)
                except queue_mod.Empty:
                    i = dead[0]
                    raise RuntimeError(f"rank {i} on {devices[i]} exited with code "
                                       f"{procs[i].exitcode} and sent no result") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(f"the ranks on {[str(d) for d in devices]} did not finish "
                                   f"within {TIMEOUT_S} s") from None
            else:
                continue
        index, status, body = msg
        if status == "error":
            raise RuntimeError(f"rank {index} on {devices[index]} raised:\n{body}")
        got[index] = _loads(body)
    return got


def run_ranks(fn: Callable, rank_args: Sequence[tuple], devices: Sequence) -> RanksRun:
    """Run `fn(rank, *rank_args[i])` in one process per device (rank i on
    devices[i]; a device may appear more than once) and return a RanksRun
    with the results in rank order. `fn` must be importable (a module-level
    function) and every tensor in `rank_args` is sent as a CPU tensor; each
    result comes back on the CPU."""
    devices = [_device(d) for d in devices]
    if not devices or len(rank_args) != len(devices):
        raise ValueError(f"{len(rank_args)} argument tuples for {len(devices)} devices")
    if any(d.type == "cuda" for d in devices) and torch.cuda.is_available():
        with ThreadPoolExecutor(len(KERNELS)) as pool:
            list(pool.map(lambda kernel: kernel.build(), KERNELS.values()))
    backend = backend_for(devices)
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, len(devices), True,
                          timeout=datetime.timedelta(seconds=TIMEOUT_S), wait_for_workers=False)
    results = ctx.Queue()
    t_spawn = time.monotonic()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(i, devices, backend, store.port, TIMEOUT_S,
                               _dumps((fn, _cpu(tuple(args)))), results))
             for i, args in enumerate(rank_args)]
    try:
        for p in procs:
            p.start()
        got = _collect(procs, results, devices, t_spawn + TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=30)
        results.close()
    outs, launches, clocks = zip(*(got[i] for i in range(len(devices))))
    t_enter, t_device, t0, t1 = (np.array(c) for c in zip(*clocks))
    return RanksRun(
        results=list(outs), launches=list(launches), backend=backend,
        ranks_per_device=max(devices.count(d) for d in devices),
        startup_s=float(t0.max() - t_spawn),
        startup_split={"imports": float(t_enter.max() - t_spawn),
                       "device": float((t_device - t_enter).max()),
                       "group": float((t0 - t_device).max())},
        fit_s=float(t1.max() - t0.min()),
    )


def lane_slices(state, n: int) -> list:
    """The lanes of a batched state (or any tree with the lanes first),
    padded to a multiple of n by cycling them, as n contiguous slices on
    the CPU (a single tail slice would underfill when n exceeds the lanes)."""
    R = ctm_base.lanes_of(state)[0]
    R_pad = -(-R // n) * n
    padded = ctm_base._index_lanes(_cpu(state), torch.arange(R_pad) % R)
    per = R_pad // n
    return [ctm_base._index_lanes(padded, torch.arange(i * per, (i + 1) * per))
            for i in range(n)]


def join_lanes(parts: list, R: int, device):
    """The slices' results back in lane order on `device`, the padding
    dropped."""
    result = ctm_base._index_lanes(ctm_base._cat_lanes(parts), torch.arange(R))
    return tree_map(lambda t: t.to(device), result)


def _fit_lane_slice(rank: Rank, fit_fn: Callable, state, args: tuple, kwargs: dict):
    """A rank of `fit_lanes`: fit its lanes on its device."""
    return fit_fn(tree_map(lambda t: t.to(rank.device), state), *args, **kwargs)


def fit_lanes(fit_fn: Callable, state, args: tuple, kwargs: dict, devices: Sequence,
              run_info: dict = None):
    """The restart fan-out for any family: the lanes of the batched `state`
    (`lane_slices`) go to one rank per device, each of which fits its slice
    uncut with `fit_fn(state, *args, **kwargs)` (a module-level
    `*_from_states` function, which moves the data to the state's device);
    the results come back in lane order on the state's device. No rank talks
    to another. `run_info`, when a dict, receives RanksRun.info()."""
    if not devices:
        raise ValueError("no devices to fan the lanes out over")
    R, device = ctm_base.lanes_of(state)
    run = run_ranks(_fit_lane_slice, [(fit_fn, part, args, kwargs)
                                      for part in lane_slices(state, len(devices))], devices)
    if run_info is not None:
        run_info.update(run.info())
    return join_lanes(run.results, R, device)
