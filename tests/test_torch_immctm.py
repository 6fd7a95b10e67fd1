"""The PyTorch IMMCTM against the JAX package's, in float64, from the same
(injected) states.

On the reference's IMMCTM fixture (tests/test_immctm.py): one CAVI step from
a mid-fit state, a 20-iteration fit and the ELBO, at rtol 1e-10 on every
state field and the ll. On a slice of the BRCA-EU cohort with the feature
factorization of tools/families_bench.py (substitution × context for SNV,
type × size/region for SV): three restart lanes fit side by side, their
float64 re-scores at rtol 1e-12, and the lane each side selects. The two
sides differ only in summation order and in the Σ inverse, all at f64
rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import immctm as jmod
from multimodalmusig_tpu.parallel.rescore import pick_optimal_restart_np
from multimodalmusig_tpu.parallel.rescore import rescore_immctm_f64 as jax_rescore

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base as tcb, ilda as tilda, immctm as tmod
from multimodalmusig_tpu_torch.parallel import restarts as tr

from conftest import requires_brca_data
from test_immctm import ALPHA, FEATURES, K, X

torch.set_num_threads(2)

RTOL = 1e-10


def _tcfg(jcfg):
    return tmod.IMMCTMConfig(K=jcfg.K, V=jcfg.V, D=jcfg.D, dtype=torch.float64, J=jcfg.J)


def _tensors(arrays):
    """Nested tuples of arrays as the same nesting of f64 CPU tensors."""
    if isinstance(arrays, (tuple, list)):
        return tuple(_tensors(a) for a in arrays)
    return torch.as_tensor(np.array(arrays, dtype=np.float64))


def _assert_states_close(got, want, rtol, lane=0, atol=1e-12):
    """Every field of lane `lane` of a port state against an unbatched JAX
    state."""
    for name in tmod.IMMCTMState._fields:
        g, w = getattr(got, name), getattr(want, name)
        flat_g, flat_w = [g], [w]
        while isinstance(flat_g[0], tuple):
            flat_g = [x for t in flat_g for x in t]
            flat_w = [x for t in flat_w for x in t]
        for a, b in zip(flat_g, flat_w):
            np.testing.assert_allclose(a[lane].numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    """The reference fixture: the JAX init state and its 20-iteration fit."""
    model = jmod.IMMCTM(K, ALPHA, FEATURES, X)
    jcfg = model.config
    assert jcfg.dtype == jnp.float64
    fit = jax.jit(jmod.fit, static_argnames=("config", "maxiter", "tol"))(
        model.state, model.Xdense, model.F, jcfg, maxiter=20, tol=0.0
    )
    return dict(model=model, jcfg=jcfg, tcfg=_tcfg(jcfg), fit=fit,
                Xt=_tensors(model.Xdense), Ft=_tensors(model.F))


def test_fit_step_matches_jax(tiny):
    """One CAVI step from the 20-iteration state: every field and the ll."""
    m, js = tiny["model"], tiny["fit"].state
    N = jmod.counts_per_doc(m.Xdense)
    want_state, want_ll = jax.jit(jmod.fit_step_fn(m.Xdense, N, m.F, tiny["jcfg"]))(js)
    step = tmod.fit_step_fn(tiny["Xt"], tcb.counts_per_doc(tiny["Xt"]), tiny["Ft"], tiny["tcfg"])
    got_state, got_ll = step(mt.immctm_state_from_numpy(js, device="cpu"))
    np.testing.assert_allclose(got_ll[0].numpy(), np.asarray(want_ll), rtol=RTOL)
    _assert_states_close(got_state, want_state, RTOL)


def test_fit_matches_jax(tiny):
    """20 iterations from the JAX init state."""
    want = tiny["fit"]
    got = tmod.fit(mt.immctm_state_from_numpy(tiny["model"].state, device="cpu"), tiny["Xt"],
                   tiny["Ft"],
                   tiny["tcfg"], maxiter=20, tol=0.0)
    assert int(got.n_iters[0]) == int(want.n_iters) == 20
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=RTOL)
    np.testing.assert_allclose(got.ll[0].numpy(), np.asarray(want.ll), rtol=RTOL)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=RTOL)
    _assert_states_close(got.state, want.state, RTOL)


def test_calculate_elbo_matches_jax(tiny):
    """The ELBO of the JAX 20-iteration state, which the JAX fit reports."""
    got = tmod.calculate_elbo(mt.immctm_state_from_numpy(tiny["fit"].state, device="cpu"),
                              tiny["Xt"],
                              tcb.counts_per_doc(tiny["Xt"]), tiny["Ft"], tiny["tcfg"])
    np.testing.assert_allclose(float(got[0]), float(tiny["fit"].elbo), rtol=RTOL)


def test_wrapper_fields_match_the_jax_wrapper(tiny):
    """The R = 1 wrapper: the reference's constructor and field surface."""
    want = tiny["model"]
    got = mt.IMMCTM(K, ALPHA, FEATURES, X, dtype=torch.float64, device="cpu")
    for name in ("K", "D", "M", "I", "J", "V", "N", "alpha"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.mu.shape == (5,) and got.Sigma.shape == (5, 5)
    for m in range(2):
        for i in range(2):
            np.testing.assert_array_equal(got.F[m][i].numpy(), np.asarray(want.F[m][i]))
    g = got.gamma
    assert len(g) == 2 and len(g[1]) == 3 and len(g[1][0]) == 2 and g[1][0][0].shape == (2,)
    np.testing.assert_allclose(got.theta[0][0].sum(axis=0), np.ones(2), rtol=1e-12)
    # with the JAX init injected, the wrapper's fit is the JAX fit
    got.state = mt.immctm_state_from_numpy(want.state, device="cpu")
    history = got.fit(maxiter=20, tol=0.0)
    np.testing.assert_allclose(history, np.asarray(tiny["fit"].ll_history), rtol=RTOL)
    assert got.ll == history[-1] and np.isfinite(got.elbo)
    for d in range(got.D):
        for m in range(got.M):
            np.testing.assert_allclose(got.props[d][m].sum(), 1.0, rtol=1e-12)
    for m in range(got.M):
        for k in range(got.K[m]):
            np.testing.assert_allclose([p.sum() for p in got.phi[m][k]], 1.0, rtol=1e-12)
    assert "fitted" in repr(got)


def test_immctm_state_from_numpy_batched_and_unbatched(tiny):
    js = tiny["fit"].state
    one = mt.immctm_state_from_numpy(js, device="cpu")
    batched = mt.immctm_state_from_numpy(
        jax.tree_util.tree_map(lambda a: np.stack([np.asarray(a)] * 2), js), device="cpu",
        dtype=torch.float32
    )
    assert one.lam.shape == (1, 2, 5) and one.lam.dtype == torch.float64
    assert batched.lam.shape == (2, 2, 5) and batched.lam.dtype == torch.float32
    assert one.alpha[1].shape == (1, 2) and one.gamma[1][0].shape == (1, 3, 2)
    assert batched.gamma[1][0].shape == (2, 3, 2)
    _assert_states_close(batched, js, rtol=1e-6, lane=1, atol=1e-6)


def test_feature_onehots_match_jax():
    from multimodalmusig_tpu.models.ilda import feature_onehots

    feats = np.array([[1, 3], [2, 1], [2, 2], [1, 3]])
    want = feature_onehots(feats, (2, 3), jnp.float64)
    for got, w in zip(tilda.feature_onehots(feats, (2, 3)), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# BRCA-EU slice: restart lanes, f64 re-scores, selection
# ---------------------------------------------------------------------------


def brca_features(snv_terms, sv_terms):
    """(V, 2) 1-based feature tables of tools/families_bench.py:66-77:
    substitution × trinucleotide context for SNV, type × size/region for SV."""
    subs = sorted({t.split("[")[1].split("]")[0] for t in snv_terms})
    ctx = sorted({t.split("[")[0] + "_" + t.split("]")[1] for t in snv_terms})
    snv = np.array([[subs.index(t.split("[")[1].split("]")[0]) + 1,
                     ctx.index(t.split("[")[0] + "_" + t.split("]")[1]) + 1] for t in snv_terms])
    svt = sorted({t.split(":")[0] for t in sv_terms})
    svr = sorted({":".join(t.split(":")[1:]) for t in sv_terms})
    sv = np.array([[svt.index(t.split(":")[0]) + 1, svr.index(":".join(t.split(":")[1:])) + 1]
                   for t in sv_terms])
    return snv, sv


@pytest.fixture(scope="module")
def brca_slice():
    """40 documents, K = (3, 3), three JAX-initialized lanes fit 12
    iterations in f64 by the JAX package."""
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
    from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

    tables = [read_counts_tsv(brca_counts_path(f)) for f in BRCA_FILES]
    Xnp = [t[0].T[:40] for t in tables]
    feats = brca_features(tables[0][1], tables[1][1])
    docs = [[mt.make_count_matrix(Xnp[m][d]) for m in range(2)] for d in range(40)]
    model = jmod.IMMCTM([3, 3], [0.1, 0.1], list(feats), docs)
    jcfg = model.config
    keys = jax.random.split(jax.random.key(5), 3)
    inits = jax.vmap(lambda k: jmod.init(k, jcfg, model.state.alpha))(keys)
    # lane by lane through one compiled fit (a vmapped fit compiles far longer)
    fit = jax.jit(lambda s: jmod.fit(s, model.Xdense, model.F, jcfg, maxiter=12, tol=0.0))
    lanes = [fit(jax.tree_util.tree_map(lambda a, r=r: a[r], inits)) for r in range(3)]
    want = jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]), *lanes)
    return dict(model=model, jcfg=jcfg, inits=inits, want=want, Xnp=Xnp, feats=feats, docs=docs)


@requires_brca_data
def test_rescore_matches_jax(brca_slice):
    b, want = brca_slice, brca_slice["want"]
    m = b["model"]
    ref = jax_rescore(want.state.lam, want.state.gamma, b["Xnp"],
                      [[np.asarray(f) for f in Fm] for Fm in m.F], b["jcfg"])
    got = mt.rescore_immctm_f64(_tensors(want.state.lam), _tensors(want.state.gamma), b["Xnp"],
                                _tensors(m.F), _tcfg(b["jcfg"]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@requires_brca_data
def test_fit_immctm_restarts_matches_jax_lanes_and_selection(brca_slice, monkeypatch):
    """fit_immctm_restarts with the JAX inits injected: every lane's ll
    history at rtol 1e-10, and the lane the JAX package's f64-rescored
    dense-rank selection picks."""
    b, want = brca_slice, brca_slice["want"]
    monkeypatch.setattr(tr.immctm_mod, "init",
                        lambda *a, **k: mt.immctm_state_from_numpy(b["inits"], device="cpu"))
    model = mt.fit_immctm_restarts([3, 3], [0.1, 0.1], list(b["feats"]), b["docs"], restarts=3,
                                   maxiter=12, tol=0.0, dtype=torch.float64, device="cpu")
    res = model.restart_result
    np.testing.assert_allclose(res.ll_history.numpy(), want.ll_history, rtol=RTOL)
    np.testing.assert_allclose(res.elbo.numpy(), want.elbo, rtol=RTOL)
    m = b["model"]
    best = pick_optimal_restart_np(jax_rescore(
        want.state.lam, want.state.gamma, b["Xnp"],
        [[np.asarray(f) for f in Fm] for Fm in m.F], b["jcfg"]))
    np.testing.assert_allclose(model.ll, want.ll[best], rtol=RTOL)
    np.testing.assert_allclose(np.stack(model.lam), want.state.lam[best], rtol=1e-8, atol=1e-10)


def test_fit_immctm_restarts_from_a_seed_is_reproducible():
    a = mt.fit_immctm_restarts(K, ALPHA, FEATURES, X, restarts=3, maxiter=8, tol=0.0, seed=4,
                               dtype=torch.float64, device="cpu")
    b = mt.fit_immctm_restarts(K, ALPHA, FEATURES, X, restarts=3, maxiter=8, tol=0.0, seed=4,
                               dtype=torch.float64, rescore_f64=False, device="cpu")
    assert torch.equal(a.restart_result.ll_history, b.restart_result.ll_history)
    assert a.restart_result.ll.shape == (3, 2) and np.isfinite(a.ll).all()
    gam = a.restart_result.state.gamma
    assert not torch.equal(gam[0][0][0], gam[0][0][1])  # lanes draw independently
