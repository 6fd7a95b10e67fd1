"""The PyTorch ILDA against the JAX package's, in float64, from the same
(injected) states.

On the 24-document BRCA-EU SNV slice of tests/test_torch_lda.py with its
terms factored into substitution × trinucleotide context (J = (6, 16), as
tools/families_bench.py:66-71 factors them), K = 3: one CAVI step, a
30-iteration fit from the JAX init and the ELBO at rtol 1e-10; η per
feature; `transform` (the JAX package's repair of the reference's dead
code) and `fit_heldout` of one trained state; `fit_ilda_restarts` from the
JAX inits and cut every way; the float64 re-scores at rtol 1e-12;
checkpoints cross-loaded both ways; the dispatch; and the reference's own
fixture (tests/test_ilda.py)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu import calculate_elbo as jax_calculate_elbo
from multimodalmusig_tpu import calculate_loglikelihood as jax_calculate_loglikelihood
from multimodalmusig_tpu.models import ilda as jil
from multimodalmusig_tpu.parallel import rescore as jrescore
from multimodalmusig_tpu.parallel import restarts as jr
from multimodalmusig_tpu.utils import io as jio

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ilda as til
from multimodalmusig_tpu_torch.parallel import restarts as tr

from conftest import requires_brca_data
from test_ilda import ALPHA as FIX_ALPHA, ETA as FIX_ETA, FEATURES as FIX_FEATURES
from test_ilda import K as FIX_K, X as FIX_X
from test_torch_lda import RTOL, assert_states_close, brca_snv_slice

pytestmark = requires_brca_data

torch.set_num_threads(2)

D, K, ALPHA = 24, 3, 0.1
ETA = [0.1, 0.05]  # one per feature
JIT_FIT = jax.jit(jil.fit, static_argnames=("config", "maxiter", "tol"))


def snv_features(terms):
    """(96, 2) 1-based substitution × context table of the SNV terms
    ("A[C>A]G"), as tools/families_bench.py:66-71 derives it."""
    subs = sorted({t.split("[")[1].split("]")[0] for t in terms})
    ctx = sorted({t.split("[")[0] + "_" + t.split("]")[1] for t in terms})
    return np.array([[subs.index(t.split("[")[1].split("]")[0]) + 1,
                      ctx.index(t.split("[")[0] + "_" + t.split("]")[1]) + 1] for t in terms])


def port_state(jax_state):
    return mt.ilda_state_from_numpy(jax_state, device="cpu")


@pytest.fixture(scope="module")
def f():
    X, docs, terms = brca_snv_slice(D + 16)
    feats = snv_features(terms)
    jmodel = jil.ILDA(K, ALPHA, ETA, feats, docs[:D])
    assert jmodel.config.dtype == jnp.float64 and jmodel.config.J == (6, 16)
    fit = JIT_FIT(jmodel.state, jmodel.Xdense, jmodel.F, jmodel.config, maxiter=30, tol=0.0)
    tmodel = mt.ILDA(K, ALPHA, ETA, feats, docs[:D], dtype=torch.float64, device="cpu")
    return dict(X=X[:D], docs=docs[:D], new=docs[D:], feats=feats, jmodel=jmodel, fit=fit,
                tmodel=tmodel)


def test_config_and_onehots_match_jax(f):
    t, j = f["tmodel"], f["jmodel"]
    assert (t.config.K, t.config.V, t.config.D, t.config.J, t.config.alpha, t.config.eta) == (
        j.config.K, j.config.V, j.config.D, j.config.J, j.config.alpha, j.config.eta)
    for a, b in zip(t.F, j.F):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("K", "D", "I", "J", "V", "alpha", "eta", "α", "η"):
        assert getattr(t, name) == getattr(j, name), name


def test_fit_step_matches_jax(f):
    js, jm = f["fit"].state, f["jmodel"]
    want_state, want_ll = jax.jit(jil.fit_step_fn(jm.Xdense, jm.F, jm.config))(js)
    t = f["tmodel"]
    got_state, got_ll = til.fit_step_fn(t.Xdense, t.F, t.config)(port_state(js))
    np.testing.assert_allclose(float(got_ll[0]), float(want_ll), rtol=RTOL)
    assert_states_close(got_state, want_state)


def test_fit_matches_jax(f):
    want, t = f["fit"], f["tmodel"]
    got = til.fit(port_state(f["jmodel"].state), t.Xdense, t.F, t.config, maxiter=30, tol=0.0)
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=RTOL)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=RTOL)
    assert_states_close(got.state, want.state)


def test_calculate_elbo_matches_jax(f):
    js, t, jm = f["fit"].state, f["tmodel"], f["jmodel"]
    np.testing.assert_allclose(float(til.calculate_elbo(port_state(js), t.Xdense, t.F,
                                                        t.config)[0]),
                               float(jil.calculate_elbo(js, jm.Xdense, jm.F, jm.config)),
                               rtol=RTOL)


def test_updates_and_word_probs_match_jax(f):
    """summed_Elnbeta, vocab_topic_probs, update_lambda with a given ϕ and
    unsmoothed_update_phi against the JAX functions."""
    js, t, jm = f["fit"].state, f["tmodel"], f["jmodel"]
    st = port_state(js)
    np.testing.assert_allclose(til.summed_Elnbeta(st.Elnbeta, t.F)[0].numpy(),
                               np.asarray(jil.summed_Elnbeta(js.Elnbeta, jm.F)), rtol=RTOL)
    np.testing.assert_allclose(til.vocab_topic_probs(til.beta_point(st), t.F)[0].numpy(),
                               np.asarray(jil.vocab_topic_probs(jil.beta_point(js), jm.F)),
                               rtol=RTOL)
    phi = np.random.default_rng(1).dirichlet(np.ones(K), (D, 96))
    assert_states_close(til.update_lambda(st, t.Xdense, t.F, t.config, torch.as_tensor(phi)[None]),
                        jil.update_lambda(js, jm.Xdense, jm.F, jm.config, jnp.asarray(phi)))
    assert_states_close(til.unsmoothed_update_phi(st, til.beta_point(st), t.F),
                        jil.unsmoothed_update_phi(js, jil.beta_point(js), jm.F))


@pytest.fixture(scope="module")
def trained(f):
    jmodel = jil.ILDA(K, ALPHA, ETA, f["feats"], f["docs"])
    jmodel.state = f["fit"].state
    tmodel = mt.ilda_from_state(f["fit"].state, ALPHA, ETA, f["feats"], f["docs"], device="cpu")
    return jmodel, tmodel


def test_transform_matches_jax(f, trained):
    jm, tm = trained
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jil.transform(jm, f["new"], maxiter=40)
        got = mt.transform(tm, f["new"], maxiter=40)
    assert got.shape == (K, 16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)


def test_fit_heldout_matches_jax(f, trained):
    jm, tm = trained
    want = jil.fit_heldout(f["new"], jm, maxiter=30)
    got = mt.fit_heldout(f["new"], tm, maxiter=30)
    assert isinstance(got, til.ILDA) and got.D == 16
    np.testing.assert_allclose([got.ll, got.elbo], [want.ll, want.elbo], rtol=RTOL)
    assert got.converged == want.converged
    assert_states_close(got.state, want.state)


@pytest.fixture(scope="module")
def restarts(f):
    """Four JAX-initialized lanes fit 20 iterations each by the JAX package,
    and the lane its f64-rescored selection picks."""
    jm = f["jmodel"]
    keys = jax.random.split(jax.random.key(11), 4)
    inits = jax.vmap(lambda k: jil.init(k, jm.config))(keys)
    lanes = [JIT_FIT(jax.tree_util.tree_map(lambda a, r=r: a[r], inits), jm.Xdense, jm.F,
                     jm.config, maxiter=20, tol=0.0) for r in range(4)]
    want = jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]), *lanes)
    F = [np.asarray(x) for x in jm.F]
    best = jr._best_scalar_ll_lane(
        want, lambda c: jrescore.rescore_ilda_f64(want.state.gamma, want.state.lam, f["X"], F,
                                                  lanes=c), True)
    return dict(inits=inits, want=want, best=best, F=F)


def test_rescore_matches_jax(f, restarts):
    st = restarts["want"].state
    gamma = np.array(st.gamma)
    gamma[1] = np.nan
    lam = [np.asarray(l) for l in st.lam]
    want = jrescore.rescore_ilda_f64(gamma, lam, f["X"], restarts["F"])
    got = mt.rescore_ilda_f64(torch.as_tensor(gamma), tuple(map(torch.as_tensor, lam)), f["X"],
                              f["tmodel"].F)
    assert bool(torch.isnan(got[1]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    sub = np.array([2, 0, 3])
    np.testing.assert_allclose(
        mt.rescore_ilda_f64(torch.as_tensor(gamma), tuple(map(torch.as_tensor, lam)), f["X"],
                            f["tmodel"].F, sub).numpy(),
        jrescore.rescore_ilda_f64(gamma, lam, f["X"], restarts["F"], lanes=sub), rtol=1e-12)


def test_fit_ilda_restarts_matches_jax_lanes_and_selection(f, restarts, monkeypatch):
    monkeypatch.setattr(tr.ilda_mod, "init",
                        lambda *a, **k: mt.ilda_state_from_numpy(restarts["inits"], device="cpu"))
    want, best = restarts["want"], restarts["best"]
    model = mt.fit_ilda_restarts(K, ALPHA, ETA, f["feats"], f["docs"], restarts=4, maxiter=20,
                                 tol=0.0, dtype=torch.float64, device="cpu")
    res = model.restart_result
    np.testing.assert_allclose(res.ll_history.numpy(), want.ll_history, rtol=RTOL)
    np.testing.assert_allclose(res.elbo.numpy(), want.elbo, rtol=RTOL)
    assert len(set(np.round(want.ll, 6))) == 4
    np.testing.assert_allclose(model.ll, want.ll[best], rtol=RTOL)
    for a, b in zip(model.lam, want.state.lam):
        np.testing.assert_allclose(a, b[best], rtol=1e-8, atol=1e-10)


@pytest.fixture(scope="module")
def uncut(f):
    return mt.fit_ilda_restarts(K, ALPHA, ETA, f["feats"], f["docs"], restarts=8, maxiter=60,
                                tol=1e-4, seed=5, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("cut", [dict(chunk_iters=9), dict(compact_schedule=(14,)),
                                 dict(compact_schedule="auto", pilot_restarts=4)],
                         ids=["chunk_iters", "pinned", "auto"])
def test_cut_fits_give_each_lanes_uncut_result(f, uncut, cut):
    want = uncut.restart_result
    assert len(set(want.n_iters.tolist())) > 1
    model = mt.fit_ilda_restarts(K, ALPHA, ETA, f["feats"], f["docs"], restarts=8, maxiter=60,
                                 tol=1e-4, seed=5, dtype=torch.float64, device="cpu", **cut)
    got = model.restart_result
    np.testing.assert_array_equal(got.n_iters.numpy(), want.n_iters.numpy())
    np.testing.assert_allclose(got.ll_history.numpy(), want.ll_history.numpy(), rtol=1e-12)
    for a, b in zip(got.state.lam, want.state.lam):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    assert model.ll == uncut.ll


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_load(f, tmp_path, writer):
    path = str(tmp_path / "ilda.npz")
    jm = jil.ILDA(K, ALPHA, ETA, f["feats"], f["docs"])
    if writer == "jax":
        jm.fit(maxiter=5, verbose=False)
        jio.save_model(path, jm)
    else:
        pm = mt.ILDA(K, ALPHA, ETA, f["feats"], f["docs"], dtype=torch.float64, device="cpu")
        pm.state = port_state(jm.state)
        pm.fit(maxiter=5, verbose=False)
        mt.save_model(path, pm)
    jl2, pl2 = jio.load_model(path), mt.load_model(path, device="cpu")
    assert type(pl2) is til.ILDA and pl2.config == f["tmodel"].config
    assert (pl2.ll, pl2.elbo, pl2.converged) == (jl2.ll, jl2.elbo, jl2.converged)
    np.testing.assert_array_equal(pl2.features, jl2.features)
    assert_states_close(pl2.state, jl2.state, rtol=0, atol=0)
    np.testing.assert_allclose(pl2.fit(maxiter=3, verbose=False), jl2.fit(maxiter=3, verbose=False),
                               rtol=RTOL)


def test_dispatch_matches_jax(f, trained):
    jm, tm = trained
    np.testing.assert_allclose(mt.calculate_elbo(tm), jax_calculate_elbo(jm), rtol=RTOL)
    np.testing.assert_allclose(mt.calculate_loglikelihood(tm), jax_calculate_loglikelihood(jm),
                               rtol=RTOL)
    docs = [d.copy() for d in f["docs"]]
    docs[3][:, 1] += 1
    np.testing.assert_allclose(mt.calculate_loglikelihood(docs, tm),
                               jax_calculate_loglikelihood(docs, jm), rtol=RTOL)
    with pytest.raises(TypeError, match="no predict_modality_eta"):
        mt.predict_modality_eta(f["new"], 1, tm)


def test_reference_fixture_fit_and_wrapper_match_jax():
    """The reference's ILDA fixture (test/ilda.jl): the wrapper's fields in
    the reference's orientation and, with the JAX init injected, its fit."""
    want = jil.ILDA(FIX_K, FIX_ALPHA, FIX_ETA, FIX_FEATURES, FIX_X)
    got = mt.ILDA(FIX_K, FIX_ALPHA, FIX_ETA, FIX_FEATURES, FIX_X, dtype=torch.float64,
                  device="cpu")
    assert got.eta == [FIX_ETA, FIX_ETA] and got.J == [2, 2]
    assert [l.shape for l in got.lam] == [(2, 2), (2, 2)] and got.gamma.shape == (2, 2)
    np.testing.assert_allclose(got.phi[0].sum(axis=0), 1.0, rtol=1e-12)
    got.state = port_state(want.state)
    history = got.fit(maxiter=15, tol=0.0, verbose=False)
    np.testing.assert_allclose(history, want.fit(maxiter=15, tol=0.0, verbose=False), rtol=RTOL)
    for name in ("lam", "beta", "Elnbeta", "λ", "β"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12, err_msg=name)
    for name in ("gamma", "theta", "Elntheta", "γ", "θ"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-8,
                                   atol=1e-12, err_msg=name)
    for a, b in zip(got.ϕ, want.ϕ):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose([got.ll, got.elbo], [want.ll, want.elbo], rtol=RTOL)
    assert "ILDA(K=2" in repr(got) and got.fit_ == got.fit


def test_vector_eta_and_its_length_check():
    assert mt.ILDA(FIX_K, FIX_ALPHA, [0.01, 0.5], FIX_FEATURES, FIX_X, device="cpu").eta == [
        0.01, 0.5]
    with pytest.raises(ValueError, match="one entry per feature"):
        mt.ILDA(FIX_K, FIX_ALPHA, [0.1, 0.1, 0.1], FIX_FEATURES, FIX_X, device="cpu")


def test_verbose_fit_prints_the_jax_label(capsys):
    model = mt.ILDA(FIX_K, FIX_ALPHA, FIX_ETA, FIX_FEATURES, FIX_X, device="cpu")
    model.fit(maxiter=3, tol=0.0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and lines[2].startswith("3\tLog-likelihood: -")
