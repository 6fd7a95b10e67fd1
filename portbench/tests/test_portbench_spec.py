"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import os
import re

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "workloads" in m
    assert all(w["chips"] == 1 for w in bench["workloads"])
    assert len(json.dumps(bench)) < 64 * 1024
    texts = [c[k] for c in bench["configs"] for k in ("why", "source")]
    texts += [w["why"] for w in bench["workloads"]] + [m["layer"] for m in bench["per_layer"]]
    for t in texts + bench["command"]:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_and_metric_resolves():
    bench = spec.load_benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["config"] in configs
        r = spec.resolve(bench, w["name"])
        assert r["config"]["name"] == w["config"]
        assert r["traffic"]["entry"] in ("cli", "fit_mmctm_restarts")
        assert any(m["name"] == "fit_s" for m in r["end_to_end"])
        assert r["per_layer"] and all(callable(read) for _, read in r["per_layer"])
        for m in r["end_to_end"] + [m for m, _ in r["per_layer"]]:
            assert spec.applies(m, w["name"])
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_a_cell_added_as_files_alone(tiny):
    """A configuration, a traffic mix and a per-layer metric that only new
    files and entries bring resolve, beside the cells already there."""
    bench, base = tiny
    r = spec.resolve(bench, "tiny_mmctm.api", base=base)
    assert r["config"]["name"] == "tiny_mmctm" and r["traffic"]["entry"] == "fit_mmctm_restarts"
    reads = dict((m["name"], read) for m, read in r["per_layer"])
    assert reads["dummy.fits"]({"fits": 3}) == 3.0
    assert spec.resolve(bench, "brca_mmctm_k7.two_stage_r100", base=base)["config"][
        "name"] == "brca_mmctm_k7"
