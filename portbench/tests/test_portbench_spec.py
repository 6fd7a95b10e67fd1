"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files; and `contract`, what a cell of any family needs of
the files it names, on BENCHMARK.json and on copies of portbench/ that add
an LDA cell as new files alone, or break one thing each."""

import filecmp
import json
import os
import re

import pytest

from portbench import check, harness, instrument, spec
from portbench.tests.test_portbench_entries import CELL, LDA_ENTRY, lda_cell  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_SUPPLIES = ("program", "HOOKS", "Job", "REQUIRED", "fit_numbers")


def chips_rule(workloads):
    """The driver's rule: 1 to 24 cells, each on 1 or 4 chips, and at most a
    quarter of them, rounded down, on four (one always may)."""
    assert 1 <= len(workloads) <= 24, f"{len(workloads)} cells"
    for w in workloads:
        assert w["chips"] in (1, 4), f"{w['name']} asks for {w['chips']} chips"
    four = [w["name"] for w in workloads if w["chips"] == 4]
    assert len(four) <= max(1, len(workloads) // 4), (
        f"{len(four)} four-chip cells of {len(workloads)}: {four}")


def contract(bench, base=spec.HERE):
    """What every cell of `bench` needs of its files under `base` (laid out
    as portbench/), whatever its family: the rule on chips; a traffic mix
    whose entry resolves; an entry that supplies `program`, `HOOKS` (an
    instrument.Hooks), `Job`, a non-empty `REQUIRED` of check.NUMBERS and
    `fit_numbers`; limits in the configuration for every required number;
    and a program, imported here, whose model module has what the Recorder
    wraps and whose restarts module has the functions the hooks name."""
    chips_rule(bench["workloads"])
    for w in bench["workloads"]:
        r = spec.resolve(bench, w["name"], base=base)
        entry = r["entry"]
        where = f"{w['name']}: entry {r['traffic']['entry']}"
        for name in ENTRY_SUPPLIES:
            assert hasattr(entry, name), f"{where} supplies no {name}"
        assert isinstance(entry.HOOKS, instrument.Hooks), f"{where}: HOOKS is no instrument.Hooks"
        required = tuple(entry.REQUIRED)
        assert required and set(required) <= set(check.NUMBERS), (
            f"{where}: REQUIRED {required} is empty or not of check.NUMBERS")
        unlimited = sorted(set(required) - set(r["config"].get("limits", {})))
        assert not unlimited, f"{where}: the configuration's limits name no {unlimited}"
        hooks, prog = entry.HOOKS, harness.program(entry)
        wraps = {hooks.model: ("fit", "fit_step_fn", "run_cavi", hooks.theta),
                 "restarts": (hooks.restarts, *hooks.selections)}
        for module, names in wraps.items():
            assert hasattr(prog, module), f"{where}: program() has no module {module}"
            lacking = [n for n in names if not hasattr(getattr(prog, module), n)]
            assert not lacking, f"{where}: program()'s {module} has no {', '.join(lacking)}"


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
    chips_rule(bench["workloads"])
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
    contract(bench)
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["config"] in configs
        r = spec.resolve(bench, w["name"])
        assert r["config"]["name"] == w["config"]
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


def test_the_contract_holds_for_a_cell_of_another_family_made_of_new_files(lda_cell):
    """PR 21's LDA cell, written into a copy of portbench/ as new files
    alone, meets the contract beside every cell of BENCHMARK.json, and no
    file that the copy shares with portbench/ was edited."""
    bench, base = lda_cell
    contract(bench, base)
    for sub in ("configs", "traffic", "entries", "metrics"):
        shared = sorted(set(os.listdir(os.path.join(base, sub)))
                        & set(os.listdir(os.path.join(spec.HERE, sub))) - {"__pycache__"})
        assert shared
        _, edited, errors = filecmp.cmpfiles(os.path.join(spec.HERE, sub),
                                             os.path.join(base, sub), shared, shallow=False)
        assert edited == [] and errors == []


# the LDA entry broken one way each: (text, its replacement, what the
# contract's message names)
BROKEN_ENTRIES = {
    "no fit_numbers": ("def fit_numbers(", "def numbers_of_a_fit(", "fit_numbers"),
    "a theta hook the program lacks": ('theta="theta_moments_one"',
                                       'theta="theta_moments_none"', "theta_moments_none"),
    "a selection the program lacks": ('selections={"rescore_lda_f64": None}',
                                      'selections={"rescore_lda_f65": None}', "rescore_lda_f65"),
    "a required number without a limit": ('REQUIRED = ("step_ll", "model_ll")',
                                          'REQUIRED = ("step_ll", "model_ll", "pick")',
                                          "limits name no ['pick']"),
}


@pytest.mark.parametrize("fault", list(BROKEN_ENTRIES))
def test_the_contract_names_what_a_broken_entry_lacks(lda_cell, fault):
    """The LDA entry without its `fit_numbers`, with a hook the program
    lacks, or requiring a number its configuration sets no limit for: the
    contract fails, naming it."""
    bench, base = lda_cell
    old, new, named = BROKEN_ENTRIES[fault]
    assert old in LDA_ENTRY
    with open(os.path.join(base, "entries", "fit_lda_restarts.py"), "w") as f:
        f.write(LDA_ENTRY.replace(old, new))
    with pytest.raises(AssertionError, match=re.escape(named)):
        contract(bench, base)


@pytest.mark.parametrize("four", [1, 2])
def test_the_contract_allows_one_four_chip_cell_of_five(lda_cell, four):
    """BENCHMARK.json's four cells and the LDA cell: one on four chips
    passes; two fail, a quarter of five rounding down to one."""
    bench, base = lda_cell
    cells = [w["name"] for w in spec.load_benchmark()["workloads"]] + [CELL]
    bench["workloads"] = [dict(w, chips=4 if i < four else 1) for i, w in enumerate(
        w for w in bench["workloads"] if w["name"] in cells)]
    assert len(bench["workloads"]) == 5
    if four == 1:
        contract(bench, base)
    else:
        with pytest.raises(AssertionError, match="2 four-chip cells of 5"):
            contract(bench, base)
