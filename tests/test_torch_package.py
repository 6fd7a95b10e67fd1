"""The PyTorch package's boundary: it imports without JAX, its solver budgets
are the JAX package's, its fit runs float32 products without TF32, and its
NumPy-only copies of the data utilities give the JAX package's output."""

import dataclasses
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
from multimodalmusig_tpu.ops import flags as jax_flags
from multimodalmusig_tpu.ops import solvers as jax_solvers
from multimodalmusig_tpu.utils import data as jax_data
from multimodalmusig_tpu.utils import fast_tsv as jax_fast_tsv
from multimodalmusig_tpu.utils import formatting as jax_formatting
from multimodalmusig_tpu.utils.hermetic import scrubbed_env

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch import interop
from multimodalmusig_tpu_torch.models import ctm_base, ilda, immctm, lda, mmctm
from multimodalmusig_tpu_torch.ops import convergence, flags, solvers
from multimodalmusig_tpu_torch.utils import data, fast_tsv, formatting

from conftest import requires_brca_data

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    """Every module of the port, found with pkgutil.walk_packages (the
    kernel wrappers, profile_step, the CLI, utils.io, ops.flags, the
    multi-device layer, the profiling utilities and the examples included),
    imports without JAX."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "before = set(sys.modules)\n"
        "import multimodalmusig_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "new = set(sys.modules) - before\n"
        "print(json.dumps([names, sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'multimodalmusig_tpu'))]))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=scrubbed_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120, check=True,
    )
    names, jax_modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"multimodalmusig_tpu_torch.models.lda",
            "multimodalmusig_tpu_torch.models.ilda",
            "multimodalmusig_tpu_torch.ops.estep_kernel",
            "multimodalmusig_tpu_torch.ops.lambda_kernel",
            "multimodalmusig_tpu_torch.ops.theta_kernel",
            "multimodalmusig_tpu_torch.ops.flags",
            "multimodalmusig_tpu_torch.utils.io",
            "multimodalmusig_tpu_torch.model_selection",
            "multimodalmusig_tpu_torch.cli",
            "multimodalmusig_tpu_torch.profile_step",
            "multimodalmusig_tpu_torch.parallel.sharding",
            "multimodalmusig_tpu_torch.parallel._ranks",
            "multimodalmusig_tpu_torch.utils.profiling",
            "multimodalmusig_tpu_torch.examples.fit_brca",
            "multimodalmusig_tpu_torch.examples.large_scale",
            "multimodalmusig_tpu_torch.examples.select_k"} <= set(names)
    assert jax_modules == []


ENTRY_POINTS = [
    ("fit_restarts", lambda: mt.fit_restarts(0, _X, _CFG, [0.1, 0.1], restarts=2, maxiter=2)),
    ("fit_restarts_auto", lambda: mt.fit_restarts_auto(0, _X, _CFG, [0.1, 0.1], restarts=2,
                                                       maxiter=2)),
    ("auto_compact_schedule", lambda: mt.auto_compact_schedule(0, _X, _CFG, [0.1, 0.1],
                                                               restarts=2, maxiter=2)),
    ("fit_immctm_restarts", lambda: mt.fit_immctm_restarts(
        [1, 1], [0.1, 0.1], _FEATURES, _DOCS, restarts=2, maxiter=2)),
    ("fit_mmctm_restarts", lambda: mt.fit_mmctm_restarts([1, 1], [0.1, 0.1], _DOCS, restarts=2,
                                                         maxiter=2)),
    ("two_stage_fit", lambda: mt.two_stage_fit(0, _X, _CFG, [0.1, 0.1], restarts=2, maxiter=2)),
    ("MMCTM", lambda: mt.MMCTM([1, 1], [0.1, 0.1], _DOCS)),
    ("IMMCTM", lambda: mt.IMMCTM([1, 1], [0.1, 0.1], _FEATURES, _DOCS)),
    ("heldout_ll_curve", lambda: mt.heldout_ll_curve([(1, 1)], _DOCS, _DOCS, [0.1, 0.1],
                                                     restarts=2, maxiter=2)),
    ("select_k_mmctm", lambda: mt.select_k_mmctm([(1, 1)], _DOCS, [0.1, 0.1], restarts=1,
                                                 maxiter=2)),
    ("mmctm_from_state", lambda: mt.mmctm_from_state(_state_fields(), _DOCS)),
    ("immctm_from_state", lambda: mt.immctm_from_state(_immctm_fields(), _FEATURES, _DOCS)),
    ("LDA", lambda: mt.LDA(2, 0.1, 0.1, _LDA_DOCS)),
    ("ILDA", lambda: mt.ILDA(2, 0.1, 0.1, _FEATURES[0], _LDA_DOCS)),
    ("fit_lda_restarts", lambda: mt.fit_lda_restarts(2, 0.1, 0.1, _LDA_DOCS, restarts=2,
                                                     maxiter=2)),
    ("fit_ilda_restarts", lambda: mt.fit_ilda_restarts(2, 0.1, 0.1, _FEATURES[0], _LDA_DOCS,
                                                       restarts=2, maxiter=2)),
    ("lda_from_state", lambda: mt.lda_from_state(_fields(_lda_state()), 0.1, 0.1, _LDA_DOCS)),
    ("ilda_from_state", lambda: mt.ilda_from_state(_fields(_ilda_state()), 0.1, 0.1,
                                                   _FEATURES[0], _LDA_DOCS)),
]
_X = [np.ones((3, 2)), np.ones((3, 2))]
_CFG = mmctm.MMCTMConfig(K=(1, 1), V=(2, 2), D=3)
_DOCS = [[np.array([[1, 2], [2, 1]]), np.array([[2, 3]])] for _ in range(3)]
_FEATURES = [np.array([[1, 1], [2, 1]]), np.array([[1, 1], [1, 2]])]
_LDA_DOCS = [np.array([[1, 2], [2, 1]]) for _ in range(3)]
_LDA_CFG = lda.LDAConfig(K=2, V=2, D=3, alpha=0.1, eta=0.1)
_ILDA_CFG = ilda.ILDAConfig(K=2, V=2, D=3, J=(2, 1), alpha=0.1, eta=(0.1, 0.1))


def _fields(state):
    """A one-lane state as plain arrays (tuples kept), as the JAX package
    hands it."""
    def arrays(v):
        return tuple(arrays(x) for x in v) if isinstance(v, tuple) else v.numpy()
    return {k: arrays(v) for k, v in state._asdict().items()}


def _lda_state():
    return lda.init(torch.Generator().manual_seed(0), _LDA_CFG, device="cpu")


def _ilda_state():
    return ilda.init(torch.Generator().manual_seed(0), _ILDA_CFG, device="cpu")


@pytest.mark.parametrize("name, call", ENTRY_POINTS, ids=[e[0] for e in ENTRY_POINTS])
def test_entry_points_default_to_the_card_and_never_fall_back(monkeypatch, name, call):
    """Each entry point's device defaults to "cuda"; with no card a call
    without a device raises an error that names device="cpu" instead of
    running on the CPU."""
    import inspect

    fn = getattr(mt, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def _immctm_config():
    return immctm.IMMCTMConfig(K=(1, 1), V=(2, 2), D=3, J=((2, 1), (1, 2)))


def _state_fields():
    """A one-lane MMCTM state as plain arrays, as the JAX package hands it."""
    state = mmctm.init(torch.Generator().manual_seed(0), _CFG, [torch.ones(3, 2)] * 2,
                       device="cpu")
    return {k: (tuple(x.numpy() for x in v) if isinstance(v, tuple) else v.numpy())
            for k, v in state._asdict().items()}


def _immctm_fields():
    state = immctm.init(torch.Generator().manual_seed(0), _immctm_config(), [[0.1, 0.1]] * 2,
                        device="cpu")

    def arrays(v):
        return tuple(arrays(x) for x in v) if isinstance(v, tuple) else v.numpy()
    return {k: arrays(v) for k, v in state._asdict().items()}


STATE_CONSTRUCTORS = [
    ("mmctm.init", lambda **kw: mmctm.init(
        torch.Generator().manual_seed(0), _CFG, [torch.ones(3, 2)] * 2, **kw)),
    ("init_with_alpha", lambda **kw: mt.init_with_alpha(
        torch.Generator().manual_seed(0), _CFG, [torch.ones(3, 2)] * 2, [0.1, 0.1], **kw)),
    ("immctm.init", lambda **kw: immctm.init(
        torch.Generator().manual_seed(0), _immctm_config(), [[0.1, 0.1]] * 2, **kw)),
    ("state_from_numpy", lambda **kw: mt.state_from_numpy(_state_fields(), **kw)),
    ("immctm_state_from_numpy", lambda **kw: mt.immctm_state_from_numpy(_immctm_fields(), **kw)),
    ("lda.init", lambda **kw: lda.init(torch.Generator().manual_seed(0), _LDA_CFG, **kw)),
    ("ilda.init", lambda **kw: ilda.init(torch.Generator().manual_seed(0), _ILDA_CFG, **kw)),
    ("lda_state_from_numpy", lambda **kw: mt.lda_state_from_numpy(_fields(_lda_state()), **kw)),
    ("ilda_state_from_numpy", lambda **kw: mt.ilda_state_from_numpy(_fields(_ilda_state()),
                                                                    **kw)),
]


@pytest.mark.parametrize("name, make", STATE_CONSTRUCTORS, ids=[c[0] for c in STATE_CONSTRUCTORS])
def test_state_constructors_default_to_the_card_and_never_fall_back(monkeypatch, name, make):
    """The exported state constructors put their state where the fits run:
    on the card unless asked for the CPU. Without a card, a call without a
    device raises the fits' error, naming device="cpu"; with it, the state
    lies on the CPU."""
    import inspect

    fn = {"mmctm.init": mmctm.init, "init_with_alpha": mt.init_with_alpha,
          "immctm.init": immctm.init, "state_from_numpy": interop.state_from_numpy,
          "immctm_state_from_numpy": interop.immctm_state_from_numpy, "lda.init": lda.init,
          "ilda.init": ilda.init, "lda_state_from_numpy": interop.lda_state_from_numpy,
          "ilda_state_from_numpy": interop.ilda_state_from_numpy}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()
    state = make(device="cpu")

    def leaves(v):
        return [t for x in v for t in leaves(x)] if isinstance(v, tuple) else [v]
    assert all(t.device.type == "cpu" for t in leaves(state))


@pytest.mark.parametrize("kind", ["LDA", "ILDA", "MMCTM"])
def test_load_model_defaults_to_the_card_and_never_falls_back(monkeypatch, tmp_path, kind):
    """A checkpoint loads onto the card unless the caller asks for the CPU;
    with no card, a load without a device raises, naming device="cpu"."""
    import inspect

    assert inspect.signature(mt.load_model).parameters["device"].default == "cuda"
    model = {"LDA": lambda: mt.LDA(2, 0.1, 0.1, _LDA_DOCS, device="cpu"),
             "ILDA": lambda: mt.ILDA(2, 0.1, 0.1, _FEATURES[0], _LDA_DOCS, device="cpu"),
             "MMCTM": lambda: mt.MMCTM([1, 1], [0.1, 0.1], _DOCS, device="cpu")}[kind]()
    path = str(tmp_path / "model.npz")
    mt.save_model(path, model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mt.load_model(path)
    assert type(mt.load_model(path, device="cpu")) is type(model)


def test_fit_of_a_default_state_runs_where_the_state_lies(monkeypatch):
    """`fit(init_with_alpha(...), X, config)` with no device anywhere: the
    state is made on the card (here, with no card, it raises before any
    work), so the fit never runs on the CPU by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = mmctm.counts_tensors([np.ones((3, 2)), np.ones((3, 2))], _CFG, "cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mt.fit(mt.init_with_alpha(torch.Generator().manual_seed(0), _CFG, X, [0.1, 0.1]), X,
               _CFG, maxiter=2)


def test_build_hash_covers_every_header(tmp_path, monkeypatch):
    """Without running nvcc: an edit to a csrc/*.cuh moves every kernel's
    build directory, and cuda_function hands the compiler `-I csrc` and the
    headers. Each kernel keeps a library of its own."""
    from multimodalmusig_tpu_torch import native_build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("lambda_newton.cu", "estep_eta.cu", "lambda_solve.cuh"):
        (csrc / name).write_bytes(open(os.path.join(native_build.CSRC_DIR, name), "rb").read())
    monkeypatch.setattr(native_build, "CSRC_DIR", str(csrc))
    assert native_build.csrc_headers() == [str(csrc / "lambda_solve.cuh")]

    def dirs():
        cmd = native_build.cuda_command()
        return [native_build.build_dir(n, [str(csrc / f"{n}.cu")], cmd,
                                       native_build.csrc_headers())
                for n in ("lambda_newton", "estep_eta")]

    before = dirs()
    assert before == dirs() and before[0] != before[1]
    with open(csrc / "lambda_solve.cuh", "a") as f:
        f.write("// an edit\n")
    after = dirs()
    assert after[0] != before[0] and after[1] != before[1]

    seen = []

    def record(name, sources, command, headers=()):
        seen.append((name, sources, command, headers))
        raise RuntimeError("recorded")

    monkeypatch.setattr(native_build, "build_shared_library", record)
    monkeypatch.setattr(native_build, "_cuda_functions", {})
    with pytest.raises(RuntimeError, match="recorded"):
        native_build.cuda_function("estep_eta", "estep_eta_launch", [])
    name, sources, command, headers = seen[0]
    assert name == "estep_eta" and sources == [str(csrc / "estep_eta.cu")]
    assert command[-2:] == ["-I", str(csrc)] and "arch=compute_90a,code=sm_90a" in command
    assert headers == [str(csrc / "lambda_solve.cuh")]


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


@pytest.mark.parametrize("full_budgets", [False, True], ids=["caps", "full budgets"])
@pytest.mark.parametrize("dtypes", [(torch.float32, np.float32), (torch.float64, np.float64)],
                         ids=["f32", "f64"])
def test_resolved_budgets_follow_the_full_budgets_flag(monkeypatch, dtypes, full_budgets):
    """MUSIG_F32_FULL_BUDGETS, as each package's flags module holds it:
    with it set, a float32 fit runs the cold-start budgets in both."""
    monkeypatch.setattr(flags, "F32_FULL_BUDGETS", full_budgets)
    monkeypatch.setattr(jax_flags, "F32_FULL_BUDGETS", full_budgets)
    port = mmctm.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtypes[0])
    ref = JaxConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtypes[1])
    got = ctm_base.resolved_budgets(port)
    assert got == jax_ctm_base.resolved_budgets(ref)
    capped = dtypes[0] == torch.float32 and not full_budgets
    assert (got["lambda_n_iter"] is not None) == capped
    # a config field still wins
    assert ctm_base.resolved_budgets(dataclasses.replace(port, nu_n_iter=9))["nu_n_iter"] == 9


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
        state = mmctm.init_with_alpha(torch.Generator().manual_seed(0), config, Xt, [0.1, 0.1],
                                      device="cpu")
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


def test_multi_device_entry_points_default_to_every_card_and_never_fall_back(monkeypatch):
    """Without `devices`, the mesh and the restart fan-out take every CUDA
    card; with no card they raise before any rank starts."""
    from multimodalmusig_tpu_torch.parallel import sharding

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sharding.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sharding.shmap_fit_restarts(0, _X, _CFG, [0.1, 0.1], restarts=2, maxiter=2)
