"""IMMCTM inference, autoα and updateΣ = false of the PyTorch port against the
JAX package, in float64 on the CPU, from one trained state handed to both
packages (`immctm_from_state`).

As for MMCTM (tests/test_torch_inference.py): the inference loops start from
λ = 0 and ν = 1 with the trained γ and E[ln ϕ] copied, so both packages run
the same computation; they are compared at rtol 1e-10, and against the
feature-factorized numpy oracles of tests/oracle_mmctm.py at that file's
tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodalmusig_tpu as jmm
from multimodalmusig_tpu.models import immctm as jmod
from multimodalmusig_tpu.utils.formatting import dense_to_sparse

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import immctm as tmod

torch.set_num_threads(2)

RTOL = 1e-10
K = (2, 2)
V = (6, 4)
# (V_m, 2) 1-based feature tables: J = ((2, 3), (2, 2))
FEATURES = [np.array([[1, 1], [1, 2], [1, 3], [2, 1], [2, 2], [2, 3]]),
            np.array([[1, 1], [1, 2], [2, 1], [2, 2]])]
ALPHA = [[0.1, 0.2], [0.15, 0.1]]
N_INFER = 30
_JIT = {}


def _jit(fn, *static):
    key = (fn, static)
    if key not in _JIT:
        _JIT[key] = jax.jit(fn, static_argnames=static)
    return _JIT[key]


def _corpus(rng, D, vocab=V):
    return [rng.integers(0, 8, (D, v)).astype(np.float64) for v in vocab]


def _docs(dense):
    per_m = [dense_to_sparse(x) for x in dense]
    return [[per_m[m][d] for m in range(len(dense))] for d in range(dense[0].shape[0])]


def _lane0(x):
    return x[0].numpy()


def _flat(x):
    return [y for t in x for y in _flat(t)] if isinstance(x, tuple) else [x]


@pytest.fixture(scope="module")
def trained():
    """A JAX IMMCTM fit for 10 iterations on 9 documents, as a JAX wrapper
    and as the port's, and new documents (one with an empty modality)."""
    rng = np.random.default_rng(17)
    docs = _docs(_corpus(rng, 9))
    jmodel = jmod.IMMCTM(list(K), ALPHA, FEATURES, docs, dtype=jnp.float64, seed=3)
    fitted = _jit(jmod.fit, "config", "maxiter", "tol")(
        jmodel.state, jmodel.Xdense, jmodel.F, jmodel.config, maxiter=10, tol=0.0)
    jmodel.state = fitted.state
    tmodel = mt.immctm_from_state(jmodel.state, FEATURES, docs, device="cpu")
    Xnew = _corpus(rng, 5)
    Xnew[1][4] = 0.0
    s = jmodel.state
    arrays = {"mu": np.asarray(s.mu), "Sigma": np.asarray(s.Sigma),
              "invSigma": np.asarray(s.invSigma),
              "gamma": [[np.asarray(g) for g in gm] for gm in s.gamma]}
    return dict(jmodel=jmodel, tmodel=tmodel, js=s, ts=tmodel.state, Xnew=Xnew,
                docs_new=_docs(Xnew), arrays=arrays, elbo=float(fitted.elbo))


def _fresh(Xnp, modalities, seed):
    """A fresh JAX IMMCTM of the given modalities over Xnp and the same state
    in the port, with both packages' config, counts and one-hot features."""
    alpha = [ALPHA[i] for i in modalities]
    features = [FEATURES[i] for i in modalities]
    jm = jmod.IMMCTM([K[i] for i in modalities], alpha, features, _docs(Xnp),
                     dtype=jnp.float64, seed=seed)
    tm = mt.IMMCTM(jm.K, alpha, features, _docs(Xnp), dtype=torch.float64, device="cpu")
    tm.state = mt.immctm_state_from_numpy(jm.state, device="cpu")
    return jm, tm


def _assert_same_result(got, want, rtol=RTOL):
    n = int(want.n_iters)
    assert int(got.n_iters[0]) == n and bool(got.converged[0]) == bool(want.converged)
    np.testing.assert_allclose(got.ll_history[0, :n].numpy(), np.asarray(want.ll_history[:n]),
                               rtol=rtol)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=rtol)
    for name in ("lam", "nu", "zeta", "mu", "Sigma", "invSigma", "alpha", "gamma"):
        for a, b in zip(_flat(getattr(got.state, name)), _flat(getattr(want.state, name))):
            np.testing.assert_allclose(_lane0(a), np.asarray(b), rtol=rtol, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("fit_gaussian", [False, True])
def test_transform_states_match_jax_and_the_oracle(trained, fit_gaussian):
    from oracle_mmctm import oracle_immctm_transform

    f = trained
    jm, tm = _fresh(f["Xnew"], (0, 1), 5)
    want = _jit(jmod.transform_states, "config", "maxiter", "tol", "fit_gaussian")(
        f["js"], jm.state, jm.Xdense, jm.F, jm.config, maxiter=6, tol=0.0,
        fit_gaussian=fit_gaussian)
    got = tmod.transform_states(f["ts"], tm.state, tm.Xdense, tm.F, tm.config, maxiter=6,
                                tol=0.0, fit_gaussian=fit_gaussian)
    _assert_same_result(got, want)
    so, ll_hist = oracle_immctm_transform(f["Xnew"], FEATURES, f["arrays"], list(K), 6,
                                          fit_gaussian=fit_gaussian)
    np.testing.assert_allclose(got.ll_history[0].numpy(), ll_hist, rtol=1e-8)
    np.testing.assert_allclose(_lane0(got.state.lam), so["lam"], rtol=1e-7, atol=1e-10)


def test_fit_heldout_states_match_jax_and_the_oracle(trained):
    from oracle_mmctm import oracle_immctm_fit_heldout

    f = trained
    jm, tm = _fresh(f["Xnew"], (0, 1), 6)
    want = _jit(jmod.fit_heldout_states, "config", "maxiter", "tol")(
        f["js"], jm.state, jm.Xdense, jm.F, jm.config, maxiter=6, tol=0.0)
    got = tmod.fit_heldout_states(f["ts"], tm.state, tm.Xdense, tm.F, tm.config, maxiter=6,
                                  tol=0.0)
    _assert_same_result(got, want)
    so, ll_hist = oracle_immctm_fit_heldout(f["Xnew"], FEATURES, f["arrays"], list(K), 6)
    np.testing.assert_allclose(got.ll_history[0].numpy(), ll_hist, rtol=1e-8)
    np.testing.assert_allclose(_lane0(got.state.lam), so["lam"], rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("m", [0, 1])
def test_predict_modality_eta_states_match_jax_and_the_oracle(trained, m):
    from oracle_mmctm import oracle_immctm_predict_eta

    f = trained
    obsM = [i for i in range(2) if i != m]
    jm, tm = _fresh([f["Xnew"][i] for i in obsM], obsM, 7)
    eta_j, obs_j, conv_j = _jit(jmod.predict_modality_eta_states, "m", "config", "obs_config",
                                "maxiter", "tol")(
        f["js"], jm.state, jm.Xdense, m, jm.F, f["jmodel"].config, jm.config, maxiter=6, tol=0.0)
    eta_t, obs_t, conv_t = tmod.predict_modality_eta_states(
        f["ts"], tm.state, tm.Xdense, m, tm.F, f["tmodel"].config, tm.config, maxiter=6, tol=0.0)
    assert eta_t.shape == (1, 5, K[m]) and bool(conv_t[0]) == bool(conv_j)
    np.testing.assert_allclose(_lane0(eta_t), np.asarray(eta_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(_lane0(obs_t.lam), np.asarray(obs_j.lam), rtol=RTOL, atol=1e-12)
    eta_o, so = oracle_immctm_predict_eta([f["Xnew"][i] for i in obsM], FEATURES, m,
                                          f["arrays"], list(K), 6)
    np.testing.assert_allclose(_lane0(eta_t), eta_o, rtol=1e-7, atol=1e-10)


def _assert_same_model(got, want, rtol=RTOL):
    assert isinstance(got, mt.IMMCTM) and got.device.type == "cpu"
    assert got.converged == want.converged
    np.testing.assert_allclose(got.ll, want.ll, rtol=rtol)
    np.testing.assert_allclose(got.elbo, want.elbo, rtol=rtol)
    np.testing.assert_allclose(got.Sigma, want.Sigma, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(np.stack(got.lam), np.stack(want.lam), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("fit_gaussian", [False, True])
def test_transform_wrapper_matches_jax(trained, fit_gaussian):
    f = trained
    want = jmm.transform(f["jmodel"], f["docs_new"], maxiter=N_INFER, fit_gaussian=fit_gaussian)
    got = mt.transform(f["tmodel"], f["docs_new"], maxiter=N_INFER, fit_gaussian=fit_gaussian)
    _assert_same_model(got, want)
    if not fit_gaussian:
        assert torch.equal(got.state.invSigma, f["ts"].invSigma)


def test_fit_heldout_wrapper_matches_jax(trained):
    f = trained
    _assert_same_model(mt.fit_heldout(f["docs_new"], f["tmodel"], maxiter=N_INFER),
                       jmm.fit_heldout(f["docs_new"], f["jmodel"], maxiter=N_INFER))


@pytest.mark.parametrize("m", [1, 2])
def test_predict_modality_eta_wrapper_matches_jax(trained, m):
    f = trained
    Xobs = [[doc[i] for i in range(2) if i != m - 1] for doc in f["docs_new"]]
    want = jmm.predict_modality_eta(Xobs, m, f["jmodel"], maxiter=N_INFER)
    got = mt.predict_modality_eta(Xobs, m, f["tmodel"], maxiter=N_INFER)
    assert len(got) == 5 and got[0].shape == (K[m - 1],)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=RTOL, atol=1e-12)


def test_docmodality_loglikelihoods_match_jax(trained):
    f = trained
    Xother = _docs(_corpus(np.random.default_rng(4), 9))
    Xother[2][1] = np.zeros((0, 2), dtype=np.int64)  # no counts in the second modality
    for args in ((), (Xother,)):
        got = mt.calculate_docmodality_loglikelihoods(*args, f["tmodel"])
        want = jmm.calculate_docmodality_loglikelihoods(*args, f["jmodel"])
        assert got.shape == (9, 2)
        np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)
        np.testing.assert_allclose(mt.calculate_loglikelihoods(*args, f["tmodel"]),
                                   jmm.calculate_loglikelihoods(*args, f["jmodel"]), rtol=RTOL)
    assert np.isnan(got[2, 1]) and np.isfinite(got).sum() == got.size - 1
    # the ELBO the JAX fit computed for its final state
    np.testing.assert_allclose(mt.calculate_elbo(f["tmodel"]), f["elbo"], rtol=RTOL)


def test_fit_with_autoalpha_and_without_the_sigma_update_matches_jax():
    """The wrapper's fit with the Julia keywords: autoα per modality and
    feature, Σ held at the identity."""
    rng = np.random.default_rng(6)
    docs = _docs(_corpus(rng, 8))
    jm = jmod.IMMCTM(list(K), ALPHA, FEATURES, docs, dtype=jnp.float64, seed=2)
    tm = mt.immctm_from_state(jm.state, FEATURES, docs, device="cpu")
    kw = {"autoα": True, "updateΣ": False}
    want = jm.fit(maxiter=10, tol=0.0, verbose=False, **kw)
    got = tm.fit_(maxiter=10, tol=0.0, verbose=False, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    for a, b in zip(tm.alpha, jm.alpha):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    assert not np.allclose(tm.alpha[0], ALPHA[0])
    np.testing.assert_array_equal(tm.Sigma, np.eye(4))
    np.testing.assert_allclose(tm.elbo, jm.elbo, rtol=RTOL)


def test_update_alpha_matches_jax(trained):
    f = trained
    want = jmod.update_alpha(f["js"], f["jmodel"].config).alpha
    got = tmod.update_alpha(f["ts"], f["tmodel"].config).alpha
    for a, b in zip(got, want):
        assert a.shape == (1, 2)
        np.testing.assert_allclose(_lane0(a), np.asarray(b), rtol=1e-12)


def test_wrapper_fields_and_aliases_match_jax(trained):
    f = trained
    got, want = f["tmodel"], f["jmodel"]
    assert got.N == want.N
    for m in range(2):
        for k in range(K[m]):
            for i in range(2):
                np.testing.assert_allclose(got.Elnphi[m][k][i], want.Elnphi[m][k][i], rtol=RTOL)
    for d in range(want.D):
        for m in range(2):
            np.testing.assert_allclose(got.theta[d][m], want.theta[d][m], rtol=RTOL)
    cls = mt.IMMCTM
    assert (cls.μ, cls.Σ, cls.invΣ, cls.α, cls.ϕ, cls.γ, cls.Elnϕ, cls.λ, cls.ν, cls.ζ,
            cls.θ) == (cls.mu, cls.Sigma, cls.invSigma, cls.alpha, cls.phi, cls.gamma,
                       cls.Elnphi, cls.lam, cls.nu, cls.zeta, cls.theta)
    assert cls.fit_ is cls.fit


def test_the_wrapper_of_fit_immctm_restarts_serves_all_three_calls(trained):
    f = trained
    model = mt.fit_immctm_restarts(list(K), ALPHA, FEATURES, f["jmodel"].X, restarts=2,
                                   maxiter=10, dtype=torch.float64, device="cpu")
    new = mt.transform(model, f["docs_new"], maxiter=N_INFER)
    heldout = mt.fit_heldout(f["docs_new"], model, maxiter=N_INFER)
    eta = mt.predict_modality_eta([[doc[1]] for doc in f["docs_new"]], 1, model,
                                  maxiter=N_INFER)
    assert np.isfinite(new.ll).all() and np.isfinite(heldout.ll).all()
    assert np.isfinite(np.stack(eta)).all() and eta[0].shape == (K[0],)
