"""Fixtures of the benchmark's CPU tests: a tiny cell made of files of its
own, laid out as portbench/ is, and a card check for the tests marked
`cuda`, decided inside a fixture."""

import json
import os
import shutil

import pytest

from portbench import spec

TINY_CONFIG = {
    "name": "tiny_mmctm", "model": "MMCTM", "source": "test fixture", "K": [3, 2],
    "V": [12, 8], "D": 30, "alpha": [0.1, 0.1], "dtype": "float32", "modalities": ["A", "B"],
    "data": {"kind": "synthetic", "seed": 1, "mean_counts": [200, 40],
             "topic_concentration": 0.3, "proportion_concentration": 0.5},
    "reduced": [], "assumed": {},
}
TINY_TRAFFIC = {
    "api": {"entry": "fit_mmctm_restarts", "kwargs": {"restarts": 6, "maxiter": 60},
            "traced_fits": 1},
    "cli": {"entry": "cli", "argv": ["--restarts", "16", "--auto-compact", "--maxiter", "60"],
            "traced_fits": 1},
}
DUMMY_METRIC = '''"""dummy.fits (fits): the window's fits, a reader that a later change adds."""


def read(run):
    return float(run["fits"])
'''


@pytest.fixture
def tiny(tmp_path):
    """(a BENCHMARK dict with the cells tiny_mmctm.api and tiny_mmctm.cli and
    a per-layer metric dummy.fits, a copy of portbench/'s configurations,
    traffic mixes, entry points and readers with their files added). The
    configuration keeps the limits of brca_mmctm_k7."""
    for sub in ("configs", "traffic", "entries", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, sub), tmp_path / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(spec.find("configs", "brca_mmctm_k7", ".json")) as f:
        limits = json.load(f)["limits"]
    (tmp_path / "configs" / "tiny_mmctm.json").write_text(
        json.dumps(dict(TINY_CONFIG, limits=limits)))
    for name, traffic in TINY_TRAFFIC.items():
        (tmp_path / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
    (tmp_path / "metrics" / "dummy.fits.py").write_text(DUMMY_METRIC)
    bench = spec.load_benchmark()
    cells = [f"tiny_mmctm.{name}" for name in TINY_TRAFFIC]
    bench["workloads"] = bench["workloads"] + [
        {"name": c, "config": "tiny_mmctm", "traffic": c.split(".")[1], "chips": 1,
         "why": "fixture"} for c in cells]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + cells
    bench["per_layer"].append({"name": "dummy.fits", "unit": "fits", "better": "higher",
                               "source": "program_counter", "layer": "entry: cli",
                               "moves": "fit_s", "workloads": cells})
    return bench, str(tmp_path)


@pytest.fixture
def cuda_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
