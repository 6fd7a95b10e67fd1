"""The PyTorch package's boundary: it imports without JAX, its solver budgets
are the JAX package's, its fit runs float32 products without TF32, and its
NumPy-only copies of the data utilities give the JAX package's output."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import ctm_base as jax_ctm_base
from multimodalmusig_tpu.models.mmctm import MMCTMConfig as JaxConfig
from multimodalmusig_tpu.ops import convergence as jax_convergence
from multimodalmusig_tpu.ops import solvers as jax_solvers
from multimodalmusig_tpu.utils import data as jax_data
from multimodalmusig_tpu.utils import fast_tsv as jax_fast_tsv
from multimodalmusig_tpu.utils import formatting as jax_formatting
from multimodalmusig_tpu.utils.hermetic import scrubbed_env

from multimodalmusig_tpu_torch.models import ctm_base, mmctm
from multimodalmusig_tpu_torch.ops import convergence, solvers
from multimodalmusig_tpu_torch.utils import data, fast_tsv, formatting

from conftest import requires_brca_data

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import multimodalmusig_tpu_torch\n"
        "new = set(sys.modules) - before\n"
        "print(json.dumps(sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'multimodalmusig_tpu'))))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=scrubbed_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    )
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("port_name, jax_name", [
    ("LAMBDA_POLISH_ITERS", "LAMBDA_POLISH_ITERS"),
    ("NU_FP_ITERS", "NU_FP_ITERS"),
    ("CG_ITER_F32_CAP", "CG_ITER_F32_CAP"),
    ("LAMBDA_NITER_F32_CAVI", "LAMBDA_NITER_F32_CAVI"),
    ("LAMBDA_POLISH_F32_CAVI", "LAMBDA_POLISH_F32_CAVI"),
    ("NU_FP_F32_CAVI", "NU_FP_F32_CAVI"),
    ("CG_F32_CAVI", "CG_F32_CAVI"),
    ("NU_LOWER_BOUND", "NU_LOWER_BOUND"),
    ("N_BACKTRACK", "_N_BACKTRACK"),
    ("POLISH_MAX_STEP", "_POLISH_MAX_STEP"),
    ("NU_POLISH_ITERS", "_N_POLISH"),
])
def test_solver_constants_equal_the_jax_ones(port_name, jax_name):
    assert getattr(solvers, port_name) == getattr(jax_solvers, jax_name)


def test_convergence_constant_equals_the_jax_one():
    assert convergence.MIN_ITERS_BEFORE_CONVERGENCE == jax_convergence.MIN_ITERS_BEFORE_CONVERGENCE


@pytest.mark.parametrize("dtypes", [(torch.float32, np.float32), (torch.float64, np.float64)])
def test_resolved_budgets_equal_the_jax_ones(dtypes):
    port = mmctm.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtypes[0])
    ref = JaxConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtypes[1])
    assert ctm_base.resolved_budgets(port) == jax_ctm_base.resolved_budgets(ref)


def test_fit_runs_float32_products_without_tf32(monkeypatch):
    """Every float32 product of the fit runs with TF32 off and matmul
    precision "highest"; the caller's settings come back afterwards."""
    seen = []

    def record():
        seen.append((
            torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
        ))

    def wrap(fn):
        def inner(*a, **k):
            record()
            return fn(*a, **k)
        return inner

    monkeypatch.setattr(mmctm, "theta_moments", wrap(mmctm.theta_moments))
    monkeypatch.setattr(mmctm, "update_Sigma_mats", wrap(mmctm.update_Sigma_mats))
    monkeypatch.setattr(ctm_base, "maximize_lambda", wrap(ctm_base.maximize_lambda))
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        rng = np.random.default_rng(0)
        X = [rng.integers(0, 9, (5, 6)).astype(np.float32), rng.integers(0, 9, (5, 4)).astype(np.float32)]
        config = mmctm.MMCTMConfig(K=(2, 2), V=(6, 4), D=5, dtype=torch.float32)
        Xt = mmctm.counts_tensors(X, config, "cpu")
        state = mmctm.init_with_alpha(torch.Generator().manual_seed(0), config, Xt, [0.1, 0.1])
        mmctm.fit(state, Xt, config, maxiter=2, tol=0.0)
        after = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
    assert len(seen) == 6
    assert set(seen) == {("highest", False, False)}
    assert after == ("high", True, True)


@requires_brca_data
def test_tsv_loader_copy_gives_the_jax_packages_output():
    for name in data.BRCA_FILES:
        path = data.brca_counts_path(name)
        assert path == jax_data.brca_counts_path(name)
        want = jax_fast_tsv.read_counts_tsv(path)
        for prefer_native in (True, False):
            got = fast_tsv.read_counts_tsv(path, prefer_native=prefer_native)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    assert fast_tsv.native_available()


@requires_brca_data
def test_formatting_copy_gives_the_jax_packages_output():
    import pandas as pd

    dfs = [pd.read_csv(data.brca_counts_path(f), sep="\t") for f in data.BRCA_FILES]
    cols = list(dfs[0].columns[1:])
    got = formatting.format_counts_mmctm(dfs, cols)
    want = jax_formatting.format_counts_mmctm(dfs, cols)
    for g_doc, w_doc in zip(got, want):
        for g, w in zip(g_doc, w_doc):
            np.testing.assert_array_equal(g, w)
    for m in range(2):
        docs = [doc[m] for doc in got]
        V = formatting.infer_vocab_size(docs)
        assert V == jax_formatting.infer_vocab_size(docs)
        dense = formatting.sparse_to_dense(docs, V)
        np.testing.assert_array_equal(dense, jax_formatting.sparse_to_dense(docs, V))
        for g, w in zip(formatting.dense_to_sparse(dense), jax_formatting.dense_to_sparse(dense)):
            np.testing.assert_array_equal(g, w)
    lda_got = formatting.format_counts_lda(dfs[0], cols)
    lda_want = jax_formatting.format_counts_lda(dfs[0], cols)
    assert all(np.array_equal(g, w) for g, w in zip(lda_got, lda_want))
