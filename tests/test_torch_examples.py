"""The port's examples (multimodalmusig_tpu_torch/examples/) run end to end
on the CPU at a few restarts and a small maxiter, with finite outputs."""

import numpy as np
import pytest
import torch

from multimodalmusig_tpu_torch.examples import fit_brca, large_scale, select_k
from multimodalmusig_tpu_torch.parallel import _ranks

from conftest import requires_brca_data

torch.set_num_threads(2)


@requires_brca_data
def test_fit_brca_runs_every_family(tmp_path):
    path = str(tmp_path / "mmctm.npz")
    out = fit_brca.main(["--device", "cpu", "--restarts", "2", "--maxiter", "6",
                         "--model", path])
    assert np.isfinite(out["lda"].ll) and np.isfinite(out["ilda"].ll)
    assert np.isfinite(out["ctm"].ll).all() and np.isfinite(out["mmctm"].ll).all()
    assert len(out["eta"]) == 5 and np.isfinite(out["eta"]).all()
    assert (tmp_path / "mmctm.npz").exists()


@requires_brca_data
@pytest.mark.parametrize("extra", [[], ["--devices", "cpu", "cpu"]], ids=["compacted", "fan-out"])
def test_large_scale_runs_compacted_or_fanned_out(monkeypatch, extra):
    monkeypatch.setattr(_ranks, "TIMEOUT_S", 120.0)
    result = large_scale.main(["--device", "cpu", "--restarts", "4", "--pilot", "2",
                               "--maxiter", "8"] + extra)
    assert result.ll.shape == (4, 2) and torch.isfinite(result.ll).all()


@requires_brca_data
def test_select_k_runs_the_sweep():
    best_k, curve = select_k.main(["--device", "cpu", "--restarts", "2", "--maxiter", "6",
                                   "--heldout-maxiter", "4", "--samples", "40"])
    assert [k for k, _ in curve] == select_k.CANDIDATES and best_k in select_k.CANDIDATES
    assert np.isfinite([ll for _, ll in curve]).all()
