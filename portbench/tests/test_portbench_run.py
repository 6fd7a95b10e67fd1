"""Runs of the harness on the CPU at a tiny size: what it refuses, what it
loads, and that the check fails a broken timed path.

The harness's look for a card is skipped here (run_cell with
device="cpu"); everything else of a run is driven as on the card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import check, harness, spec

ROOT = spec.ROOT


def _env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **extra)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_without_a_card_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "brca_mmctm_k7.two_stage_r100",
         "--seed", "2147483905", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_a_run_without_the_package_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "brca_mmctm_k7.two_stage_r100",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "multimodalmusig_tpu_torch_x", sys)
    before = harness.forbidden_modules()
    assert "multimodalmusig_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "multimodalmusig_tpu.fake", sys)
    assert set(harness.forbidden_modules()) - set(before) == {"jaxlib", "multimodalmusig_tpu"}


LOADED = r"""
import json, sys
from portbench.tests.test_portbench_run import tiny_run_in_process
tiny_run_in_process(sys.argv[1])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def tiny_run_in_process(base):
    """One tiny CPU run of the fixture cell, in this process."""
    bench = spec.load_benchmark()
    bench["workloads"].append({"name": "tiny_mmctm.cli", "config": "tiny_mmctm",
                               "traffic": "cli", "chips": 1, "why": "fixture"})
    r = spec.resolve(bench, "tiny_mmctm.cli", base=base)
    harness.run_cell(r, 5, 0.0, 1, device="cpu")


def test_nothing_of_jax_is_loaded(tiny):
    """What a run loads, the port, the reference and the trace included:
    no module whose top-level name is jax, jaxlib, flax or
    multimodalmusig_tpu, and multimodalmusig_tpu_torch passes."""
    _, base = tiny
    proc = subprocess.run([sys.executable, "-c", LOADED, base], cwd=ROOT,
                          env=_env(JAX_PLATFORMS="cpu"), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "multimodalmusig_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def _run(tiny, cell, trace=0):
    bench, base = tiny
    return harness.run_cell(spec.resolve(bench, cell, base=base), 2147483999, 0.0, trace,
                            device="cpu")


@pytest.mark.parametrize("cell", ["tiny_mmctm.api", "tiny_mmctm.cli"])
def test_a_sound_run_is_correct(tiny, cell):
    result = _run(tiny, cell, trace=1)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] == 1 and result["failed"] == 0
    names = set(result["metrics"])
    assert {"restarts.lane_util", "restarts.steps_per_fit", "cavi.step_ms", "dummy.fits"} <= names
    assert ("cli.outside_fit_share" in names) == cell.endswith("cli")
    assert result["device"]["platform"] == "cpu"


def test_end_to_end_metrics_of_a_run(tiny):
    result = _run(tiny, "tiny_mmctm.api")
    assert set(result["metrics"]) == {"fit_s", "peak_mem_gib", "setup_s"}
    assert result["metrics"]["fit_s"]["value"] > 0


def _unchanged_step(orig):
    def fit_step_fn(*args, **kwargs):
        step = orig(*args, **kwargs)

        def unchanged(s):
            _, ll = step(s)
            return s, ll
        return unchanged
    return fit_step_fn


def _half_mean(orig):
    def update_mu_vec(lam, reduce=None, D=None):
        return lam[:, : lam.shape[1] // 2].mean(dim=-2)
    return update_mu_vec


def _altered_ll(orig):
    def fit_mmctm_restarts(*args, **kwargs):
        model = orig(*args, **kwargs)
        model.ll = [v * (1 + 1e-4) for v in model.ll]
        return model
    return fit_mmctm_restarts


def _altered_props(orig):
    def write_props(path, model, samples, modalities):
        orig(path, model, samples, modalities)
        with open(path) as f:
            lines = f.read().splitlines()
        head, first, rest = lines[0], lines[1].split("\t"), lines[2:]
        first[1] = repr(float(first[1]) + 1e-4)
        with open(path, "w") as f:
            f.write("\n".join([head, "\t".join(first), *rest]) + "\n")
    return write_props


FAULTS = {
    "step returns its state unchanged": ("models.mmctm", "fit_step_fn", _unchanged_step),
    "half the documents, mean over the rest": ("models.mmctm", "update_mu_vec", _half_mean),
    "the selected model's ll altered": ("parallel.restarts", "fit_mmctm_restarts",
                                        _altered_ll),
    "a written proportion altered": ("utils.io", "write_props", _altered_props),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    import importlib

    module, name, make = FAULTS[fault]
    mod = importlib.import_module(f"multimodalmusig_tpu_torch.{module}")
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    cell = "tiny_mmctm.cli" if name == "write_props" else "tiny_mmctm.api"
    result = _run(tiny, cell)
    assert not result["correct"], result["checks"]


def test_a_step_the_harness_cannot_see_is_not_correct(tiny, monkeypatch):
    """If the program stops calling its step through `mmctm.fit_step_fn`,
    the step numbers go unread, and a run with them unread is not
    correct."""
    from portbench.instrument import Recorder

    monkeypatch.setattr(Recorder, "_wrap_step_fn", lambda self, orig: orig)
    result = _run(tiny, "tiny_mmctm.api")
    assert not result["correct"]
    assert all(result["checks"][n][0] is None for n in ("eta", "theta", "mstep", "step_ll"))
    assert result["checks"]["model_ll"][0] is not None


def test_a_required_number_left_unread_fails():
    cli, api = spec.load_entry("cli"), spec.load_entry("fit_mmctm_restarts")
    limits = dict.fromkeys(check.NUMBERS, 1.0)
    values = dict.fromkeys(check.NUMBERS, 0.5)
    assert check.judge(values, limits, check.required(cli)) == (
        True, {n: [0.5, 1.0] for n in check.NUMBERS})
    values["outputs"] = None
    ok, checks = check.judge(values, limits, check.required(api))
    assert ok and "outputs" not in checks
    ok, checks = check.judge(values, limits, check.required(cli))
    assert not ok and checks["outputs"] == [None, 1.0]
    values["outputs"], values["eta"] = 0.5, None
    assert not check.judge(values, limits, check.required(api))[0]


def test_lambda_is_held_where_the_budgeted_solve_reaches_the_optimum():
    held = [(t, final) for t in range(12) for final in (False, True)
            if check.holds_lambda(t, final)]
    assert held == [(1, False), (1, True), (2, False), (2, True)] + [
        (t, True) for t in range(3, 12)]


def test_the_fit_seeds_differ_and_repeat():
    seeds = [harness.fit_seed(2**31 + 5, i) for i in range(50)]
    assert len(set(seeds)) == 50 and seeds == [harness.fit_seed(2**31 + 5, i) for i in range(50)]
    assert harness.fit_seed(-3, 0) != harness.fit_seed(3, 0)
