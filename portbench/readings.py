"""The readings that the check's limits are set from, for one cell, in one
process: set-up once, then per seed one fit of the cell's job at its own
size, sampled as a run samples it, and the check's numbers of the program
and, with --control, of the control (the reference one precision below,
portbench/check.py) on the same captured inputs, and, where the cell's
entry has `step_components`, each captured step's gaps by component. With
--every LO HI every step in [LO, HI) of each fit phase is captured,
besides its last.

    python3 -m portbench.readings --workload <name> --seeds 1 2 3 [--control]

Prints one JSON line per seed: {"seed", "program": {...}, "control": {...},
"steps": [...]}. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from . import check, corpus, harness, spec
from .instrument import Recorder


def main(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--every", type=int, nargs=2, metavar=("LO", "HI"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("portbench.readings: no CUDA card", file=sys.stderr)
        return 3
    resolved = spec.resolve(spec.load_benchmark(), args.workload)
    config, traffic, entry = resolved["config"], resolved["traffic"], resolved["entry"]
    prog = harness.program(entry)
    recorder = (Recorder(prog, entry.HOOKS, capture_steps=[args.every], capture_every=True)
                if args.every else Recorder(prog, entry.HOOKS))
    components = getattr(entry, "step_components", None)
    recorder.install()
    try:
        data = corpus.load(config)
        X = data["X"]
        outdir = os.path.join(tempfile.gettempdir(), "portbench", "readings", args.workload)
        job = entry.Job(prog, config, traffic, data, outdir, dev, recorder.span)
        job.run(harness.fit_seed(args.seeds[0], -1))
        for seed in args.seeds:
            recorder.begin_fit(np.random.default_rng(np.random.SeedSequence(
                [harness._entropy(seed), 0x5A3D, 0])))
            ok = job.run(harness.fit_seed(seed, 0))
            rec = recorder.end_fit()
            if hasattr(job, "read_tables"):
                rec["tables"] = job.read_tables()
            line = {"seed": seed, "ok": ok,
                    "program": check.numbers(entry, [rec], X, config, dev)}
            if args.control:
                line["control"] = check.numbers(entry, [rec], X, config, dev, control=True)
            if components is not None:
                line["steps"] = [
                    {"phase": i, "steps": p["steps"], "R": c["R"], "t": c["t"],
                     "last": c.get("last", False),
                     "program": components(c, X, config, dev),
                     "control": (components(c, X, config, dev, control=True)
                                 if args.control else None)}
                    for i, p in enumerate(rec["phases"]) for c in p["captures"]]
            print(json.dumps(line), flush=True)
    finally:
        recorder.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())
