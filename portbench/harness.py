"""One run of one cell: set-up, the measured window, the traced fits, the
check, and the result line.

The window is a closed loop with one client: the cell's job (one call of
the entry point the traffic mix names, portbench/entries/<entry>.py) runs
back to back, fit i with a restart seed drawn from (--seed, i), until the
first fit that ends after --seconds. Two fits of the window, sampled from
the seed as they start (reservoir sampling), keep what the check compares
(portbench/check.py).
"""

from __future__ import annotations

import gc
import os
import statistics
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check, corpus, program_trace, trace as trace_mod, yardstick
from .instrument import Recorder

SAMPLED_FITS = 2
TRACE_SEED_OFFSET = 1 << 20
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodalmusig_tpu")


def program(entry):
    """The modules of the package under test that a run drives: the η and θ
    kernels' wrappers, which every family's step launches, and those that
    the cell's entry names (its `program()`)."""
    from multimodalmusig_tpu_torch.ops import estep_kernel, theta_kernel
    return SimpleNamespace(estep_kernel=estep_kernel, theta_kernel=theta_kernel,
                           **entry.program())


def _entropy(seed):
    return int(seed) & 0xFFFFFFFFFFFFFFFF


def fit_seed(seed, i):
    """The restart seed of fit i of a run with --seed `seed`."""
    ss = np.random.SeedSequence([_entropy(seed), int(i) + 1])
    return int(ss.generate_state(1, dtype=np.uint32)[0])


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _launches(prog):
    return {"eta": prog.estep_kernel.LAUNCHES, "theta": prog.theta_kernel.LAUNCHES}


def run_cell(resolved, seed, seconds, trace, device="cuda", t_start=None, log=sys.stderr):
    """Run the cell once; returns the result line's dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic, cell = resolved["config"], resolved["traffic"], resolved["cell"]
    entry = resolved["entry"]
    prog = program(entry)
    recorder = Recorder(prog, entry.HOOKS)
    recorder.install()
    try:
        t_data = time.perf_counter()
        data = corpus.load(config)
        outdir = os.path.join(tempfile.gettempdir(), "portbench", cell["name"])
        job = entry.Job(prog, config, traffic, data, outdir, device, recorder.span)
        # set-up: one fit warms the cell's shapes and builds or loads the kernels
        t_warm = time.perf_counter()
        job.run(fit_seed(seed, -1))
        _sync(device)
        t_end = time.perf_counter()
        setup_s = t_end - t_start
        print(f"portbench: set-up {setup_s!r} s: start and imports {t_data - t_start!r}, "
              f"corpus {t_warm - t_data!r}, warm fit {t_end - t_warm!r}", file=log)

        # the measured window
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        recorder.reset()
        chooser = np.random.default_rng(np.random.SeedSequence([_entropy(seed), 0xC0FFEE]))
        samples, walls, failed = [None] * SAMPLED_FITS, [], 0
        t_w0 = time.perf_counter()
        while True:
            i = len(walls)
            slot = i if i < SAMPLED_FITS else int(chooser.integers(0, i + 1))
            sampled = slot < SAMPLED_FITS
            recorder.begin_fit(np.random.default_rng(np.random.SeedSequence(
                [_entropy(seed), 0x5A3D, i])) if sampled else None)
            t0 = time.perf_counter()
            try:
                ok = job.run(fit_seed(seed, i))
            except Exception as exc:  # a failing fit is counted, and the run goes on
                print(f"portbench: fit {i} raised {type(exc).__name__}: {exc}", file=log)
                ok = False
            _sync(device)
            walls.append(time.perf_counter() - t0)
            rec = recorder.end_fit()
            if rec is not None and ok:
                if hasattr(job, "read_tables"):
                    rec["tables"] = job.read_tables()
                samples[slot] = rec
            failed += not ok
            if time.perf_counter() - t_w0 >= seconds:
                break
        window_s = time.perf_counter() - t_w0
        mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        run = {
            "workload": cell["name"], "config": config, "traffic": traffic,
            "fits": len(walls), "window_s": window_s, "fit_walls": walls,
            "restarts_s": recorder.restarts_s, "steps": recorder.steps,
            "lane_steps": recorder.lane_steps, "loop_s": recorder.loop_s,
            "lane_iters_needed": recorder.lane_iters_needed(), "entry": entry,
            "yardstick": yardstick,
        }

        summary = None
        if trace:
            summary = _traced_fits(prog, recorder, job, seed, traffic, device, run)
        job = None
    finally:
        recorder.uninstall()
    if device == "cuda":
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        raise SystemExit(f"portbench: the run loaded {', '.join(found)}")

    samples = [s for s in samples if s is not None]
    values = check.numbers(entry, samples, data["X"], config, device)
    ok, checks = check.judge(values, config["limits"], check.required(entry))
    correct = ok and failed == 0 and len(samples) > 0

    metrics = {}
    if trace:
        for entry, read in resolved["per_layer"]:
            value = read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    else:
        e2e = {
            "fit_s": window_s / len(walls),
            "fit_s_p90": (statistics.quantiles(walls, n=10)[-1] if len(walls) >= 2
                          else walls[0]),
            "peak_mem_gib": mem_peak / 2**30,
            "setup_s": setup_s,
        }
        for entry in resolved["end_to_end"]:
            if entry["name"] in e2e:
                metrics[entry["name"]] = {"value": e2e[entry["name"]], "unit": entry["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": len(walls), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def _run_traced(recorder, job, seed, n, device):
    for j in range(n):
        with recorder.span("portbench.fit"):
            job.run(fit_seed(seed, TRACE_SEED_OFFSET + j))
            _sync(device)


def _traced_fits(prog, recorder, job, seed, traffic, device, run):
    """Trace the traffic's `traced_fits` fits after the window, twice on the
    same seeds: first under the program's tracer alone, which the host-span
    readers read, then under torch.profiler too, which slows the host and
    so comes second. Add to `run` each set's snapshot of the program's
    tracer (portbench/program_trace.py), the device trace's summary and
    what the kernels' wrappers counted in the profiled set."""
    n = int(traffic.get("traced_fits", 2))
    program_trace.reset()
    recorder.reset()
    # a full collection of the process's heap takes 0.1-0.2 s: one now, so
    # that none stalls the few traced fits
    gc.collect()
    with program_trace.recording():
        _run_traced(recorder, job, seed, n, device)
    unprofiled = program_trace.snapshot(recorder.lane_steps)

    program_trace.reset()
    recorder.reset()
    gc.collect()
    recorder.tracing = True
    before = _launches(prog)
    try:
        with program_trace.recording():
            if device == "cuda":
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    _run_traced(recorder, job, seed, n, device)
                events = prof.profiler.kineto_results.events()
            else:  # no device activity to record
                _run_traced(recorder, job, seed, n, device)
                events = []
    finally:
        recorder.tracing = False
    after = _launches(prog)
    profiled = program_trace.snapshot(recorder.lane_steps)
    run["program"] = {"unprofiled": unprofiled, "profiled": profiled}
    fits = [sp for sp in recorder.spans if sp[2] == "portbench.fit"]
    summary = trace_mod.summarize(events, recorder.spans, fits[0][0], fits[-1][1],
                                  program=profiled["records"] if profiled else ())
    print(f"portbench: traced {n} fits; the first device event {summary['first_device_s']!r} s "
          "after the first fit began", file=sys.stderr)
    run["trace"] = summary
    run["traced"] = {"eta": dict(recorder.kernels["eta"], launches=after["eta"] - before["eta"]),
                     "theta": dict(recorder.kernels["theta"],
                                   launches=after["theta"] - before["theta"]),
                     "lane_steps": recorder.lane_steps}
    return summary
