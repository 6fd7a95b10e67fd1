"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (portbench/configs/<config>.json) and a
traffic mix (portbench/traffic/<traffic>.json); the mix's `"entry"` names
the entry point it calls, portbench/entries/<entry>.py; a per-layer metric
is read by portbench/metrics/<name>.py, whose `read(run)` returns the
value or None. A configuration, a traffic mix, an entry point or a reader
is added as a new file and a new entry in BENCHMARK.json or in the file
that names it, with no edit to a file already there.

An entry file supplies, for its model family (MMCTM's shared part:
portbench/families/mmctm.py):
  * `program()`: {name: module} of the package under test that its fits
    run through, `restarts` and the model module among them;
  * `HOOKS`: what the Recorder wraps and captures (instrument.Hooks);
  * `Job(prog, config, traffic, data, outdir, device, span)`: set-up from
    the configuration and its corpus (portbench/corpus.py); `run(seed)`
    fits once and returns whether the answer is finite; where the entry
    writes tables, `read_tables()` reads them back;
  * `REQUIRED`: the numbers of check.NUMBERS that its runs must read, and
    `fit_numbers(sample, X, config, device, control)`: a sampled fit's
    numbers against a plain reference (portbench/check.py);
  * optionally `step_flops_per_lane(config)`, the operations of one CAVI
    step of one lane (`device.step_mfu`), and `step_components` (the
    per-component gaps that portbench/readings.py prints).
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path):
    with open(path) as f:
        return json.load(f)


def find(kind, name, ext, base=HERE):
    """<base>/<kind>/<name><ext>, `base` laid out as portbench/ is."""
    path = os.path.join(base, kind, f"{name}{ext}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind}/{name}{ext} under {base}")
    return path


def _load(kind, name, base):
    """The module of <base>/<kind>/<name>.py."""
    path = find(kind, name, ".py", base)
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(name, base=HERE):
    """The `read` function of a per-layer metric's reader."""
    return _load("metrics", name, base).read


def load_entry(name, base=HERE):
    """The module of an entry point's file."""
    return _load("entries", name, base)


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench, workload, base=HERE):
    """Everything one cell needs: {"cell", "config", "traffic", "entry" (the
    module of the traffic's entry point), "end_to_end": [metric entries],
    "per_layer": [(entry, read)]}, its files found under `base`
    (portbench/)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = _json(find("configs", cell["config"], ".json", base))
    traffic = _json(find("traffic", cell["traffic"], ".json", base))
    return {
        "cell": cell,
        "config": config,
        "traffic": traffic,
        "entry": load_entry(traffic["entry"], base),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [(m, load_metric(m["name"], base)) for m in bench["per_layer"]
                      if applies(m, workload)],
    }
