"""Entry points found by name (portbench/entries/<entry>.py): a cell of a
second family, LDA through `fit_lda_restarts`, made of new files alone
(a configuration, a traffic mix and an entry file, written here into a copy
of portbench/'s files), runs through the harness to a correct result, its
steps counted; a fault in its fit is caught; every attribute the Recorder
patched is restored; an unknown entry fails where the cell is resolved;
an entry requires only numbers of check.NUMBERS; and `device.step_mfu`
takes its count of operations from the entry."""

import json
import os

import pytest

from portbench import check, harness, spec, yardstick
from portbench.tests.test_portbench_run import _unchanged_step

LDA_CONFIG = {
    "name": "tiny_lda", "model": "LDA", "source": "test fixture", "K": [3], "V": [12],
    "D": 30, "alpha": [0.1], "eta": 0.1, "dtype": "float32", "modalities": ["A"],
    "data": {"kind": "synthetic", "seed": 3, "mean_counts": [200],
             "topic_concentration": 0.3, "proportion_concentration": 0.5},
    "reduced": [], "assumed": {},
    "limits": {"step_ll": 1e-5, "model_ll": 1e-5},
}
LDA_TRAFFIC = {"entry": "fit_lda_restarts", "kwargs": {"restarts": 6, "maxiter": 60},
               "traced_fits": 1}
LDA_ENTRY = '''"""Entry `fit_lda_restarts`: one call of the port's best-of-N LDA fit on
the first modality of the configuration's corpus, its lls held to a
float64 recomputation from the captured states."""

import numpy as np
import torch

from portbench import check, corpus
from portbench.instrument import Hooks

REQUIRED = ("step_ll", "model_ll")


def program():
    from multimodalmusig_tpu_torch.models import lda
    from multimodalmusig_tpu_torch.parallel import restarts
    return {"lda": lda, "restarts": restarts}


def capture_model(model):
    return {"model": {"ll": float(model.ll), "lam": model.state.lam[0],
                      "gamma": model.state.gamma[0]}}


HOOKS = Hooks(model="lda", theta="theta_moments_one",
              lanes=lambda s: (s.gamma.shape[0], s.gamma.device),
              restarts="fit_lda_restarts", capture_model=capture_model,
              selections={"rescore_lda_f64": None},
              step_inputs=("lam", "gamma"), step_outputs=("lam", "gamma"))


def lls(X, gamma, lam):
    """(R,) per-word lls of θ = γ normalized (R, D, K) and β = λ normalized
    over the vocabulary (R, V, K), in float64."""
    gamma, lam = gamma.double(), lam.double()
    p = (gamma / gamma.sum(-1, keepdim=True)) @ (lam / lam.sum(-2, keepdim=True)).mT
    return (X * torch.log(torch.where(X > 0, p, torch.ones_like(p)))).sum((-2, -1)) / X.sum()


def fit_numbers(sample, X, config, device, control=False):
    X64 = torch.as_tensor(X[0], dtype=torch.float64)
    steps = [check.ll_gap(c["out"]["ll"], lls(X64, c["out"]["gamma"], c["out"]["lam"]))
             for p in sample["phases"] for c in p["captures"]]
    m = sample["model"]
    return {"step_ll": check.worst(steps),
            "model_ll": check.ll_gap([m["ll"]], lls(X64, m["gamma"][None], m["lam"][None]))}


class Job:
    def __init__(self, prog, config, traffic, data, outdir, device, span):
        self.p, self.config, self.traffic, self.device = prog, config, traffic, device
        self.docs = [doc[0] for doc in corpus.sparse_docs(data["X"])]

    def run(self, seed):
        c = self.config
        model = self.p.restarts.fit_lda_restarts(
            c["K"][0], c["alpha"][0], c["eta"], self.docs, V=c["V"][0], seed=seed,
            device=self.device, **self.traffic.get("kwargs", {}))
        return bool(np.isfinite(model.ll))
'''
CELL = "tiny_lda.api"


@pytest.fixture
def lda_cell(tiny):
    """The tiny fixture's copy of portbench/ with an LDA cell added as three
    new files, and the cell in BENCHMARK's workloads and in those of the
    restart-layer metrics."""
    bench, base = tiny
    with open(os.path.join(base, "configs", "tiny_lda.json"), "w") as f:
        json.dump(LDA_CONFIG, f)
    with open(os.path.join(base, "traffic", "lda_api.json"), "w") as f:
        json.dump(LDA_TRAFFIC, f)
    with open(os.path.join(base, "entries", "fit_lda_restarts.py"), "w") as f:
        f.write(LDA_ENTRY)
    bench["workloads"].append({"name": CELL, "config": "tiny_lda", "traffic": "lda_api",
                               "chips": 1, "why": "fixture"})
    for m in bench["per_layer"]:
        if m["name"] in ("restarts.steps_per_fit", "restarts.lane_util", "cavi.step_ms"):
            m["workloads"].append(CELL)
    return bench, base


def _run(lda_cell, trace=0):
    bench, base = lda_cell
    return harness.run_cell(spec.resolve(bench, CELL, base=base), 2**31 + 41, 0.0, trace,
                            device="cpu")


def test_a_second_family_runs_from_new_files_alone(lda_cell):
    assert not os.path.exists(os.path.join(spec.HERE, "entries", "fit_lda_restarts.py"))
    result = _run(lda_cell, trace=1)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"step_ll", "model_ll"}
    assert result["attempted"] == 1 and result["failed"] == 0
    metrics = result["metrics"]
    assert metrics["restarts.steps_per_fit"]["value"] > 0
    assert 0 < metrics["restarts.lane_util"]["value"] <= 100
    assert metrics["cavi.step_ms"]["value"] > 0


def _altered_ll(orig):
    def fit_lda_restarts(*args, **kwargs):
        model = orig(*args, **kwargs)
        model.ll *= 1 + 1e-4
        return model
    return fit_lda_restarts


LDA_FAULTS = {
    "step returns its state unchanged": ("models.lda", "fit_step_fn", _unchanged_step),
    "the selected model's ll altered": ("parallel.restarts", "fit_lda_restarts", _altered_ll),
}


@pytest.mark.parametrize("fault", list(LDA_FAULTS))
def test_a_fault_in_the_second_familys_fit_is_not_correct(lda_cell, monkeypatch, fault):
    import importlib

    module, name, make = LDA_FAULTS[fault]
    mod = importlib.import_module(f"multimodalmusig_tpu_torch.{module}")
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    result = _run(lda_cell)
    assert not result["correct"], result["checks"]


def _attributes(cell, bench, base):
    entry = spec.resolve(bench, cell, base=base)["entry"]
    return {(key, name): value for key, module in vars(harness.program(entry)).items()
            for name, value in vars(module).items()}


@pytest.mark.parametrize("cell", [CELL, "tiny_mmctm.api", "tiny_mmctm.cli"])
def test_every_patched_attribute_is_restored(lda_cell, cell):
    bench, base = lda_cell
    before = _attributes(cell, bench, base)
    harness.run_cell(spec.resolve(bench, cell, base=base), 2**31 + 43, 0.0, 1, device="cpu")
    after = _attributes(cell, bench, base)
    assert after.keys() == before.keys()
    assert [k for k in before if after[k] is not before[k]] == []


def test_an_unknown_entry_fails_where_the_cell_is_resolved(tiny):
    bench, base = tiny
    with open(os.path.join(base, "traffic", "nowhere.json"), "w") as f:
        json.dump({"entry": "fit_nothing", "kwargs": {}}, f)
    bench["workloads"].append({"name": "tiny_mmctm.nowhere", "config": "tiny_mmctm",
                               "traffic": "nowhere", "chips": 1, "why": "fixture"})
    with pytest.raises(FileNotFoundError, match="entries/fit_nothing.py"):
        spec.resolve(bench, "tiny_mmctm.nowhere", base=base)


def test_an_entry_may_require_only_numbers_a_limit_can_name():
    from types import SimpleNamespace

    assert check.required(SimpleNamespace(REQUIRED=("model_ll",))) == ("model_ll",)
    with pytest.raises(ValueError, match="not among check.NUMBERS"):
        check.required(SimpleNamespace(REQUIRED=("model_ll", "elbo")))


def test_step_mfu_takes_the_operations_from_the_entry(lda_cell):
    bench, base = lda_cell
    read = spec.load_metric("device.step_mfu")
    trace = {"busy_s": 0.25}
    for cell in ("brca_mmctm_k7.two_stage_r100", "pcawg_mmctm_k775.two_stage_r100",
                 "brca_mmctm_k7.cli_r1000_auto"):
        r = spec.resolve(bench, cell)
        c = r["config"]
        per_lane = yardstick.step_flops_per_lane(c["D"], c["K"], c["V"])
        assert r["entry"].step_flops_per_lane(c) == per_lane
        run = {"trace": trace, "traced": {"lane_steps": 12345}, "config": c,
               "entry": r["entry"], "yardstick": yardstick}
        assert read(run) == 100.0 * (per_lane * 12345) / (0.25 * yardstick.PEAK_F32_FLOPS)
    lda = spec.resolve(bench, CELL, base=base)
    assert read({"trace": trace, "traced": {"lane_steps": 12345}, "config": lda["config"],
                 "entry": lda["entry"], "yardstick": yardstick}) is None
