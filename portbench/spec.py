"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (portbench/configs/<config>.json) and a
traffic mix (portbench/traffic/<traffic>.json); a per-layer metric is read
by portbench/metrics/<name>.py, whose `read(run)` returns the value or
None. Adding any of them takes new files and a new entry, no edit.
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


def load_metric(name, base=HERE):
    """The `read` function of a per-layer metric's reader."""
    path = find("metrics", name, ".py", base)
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench, workload, base=HERE):
    """Everything one cell needs: {"cell", "config", "traffic",
    "end_to_end": [metric entries], "per_layer": [(entry, read)]}, its files
    found under `base` (portbench/)."""
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
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, workload)],
        "per_layer": [(m, load_metric(m["name"], base)) for m in bench["per_layer"]
                      if applies(m, workload)],
    }
