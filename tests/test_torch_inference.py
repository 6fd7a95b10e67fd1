"""MMCTM and CTM inference, autoα, updateΣ = false, the top-level dispatch and
model_selection of the PyTorch port against the JAX package, in float64 on
the CPU, from one trained state handed to both packages.

`transform`, `fit_heldout` and `predict_modality_eta` start from λ = 0 and
ν = 1 with the trained γ and E[ln ϕ] copied, so given the same trained state
the two packages run the same computation with no random draw. They are
compared at rtol 1e-10 (the standard of tests/test_trajectory_oracle.py for
whole trajectories; the sides differ in summation order and in the Cholesky
inverse), the α solver at rtol 1e-12, and against the numpy oracles of
tests/oracle_mmctm.py at that file's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodalmusig_tpu as jmm
from multimodalmusig_tpu import model_selection as jsel
from multimodalmusig_tpu.models import ctm_base as jcb, mmctm as jm
from multimodalmusig_tpu.ops import solvers as jsolvers
from multimodalmusig_tpu.utils.formatting import dense_to_sparse
from multimodalmusig_tpu.utils import io as jio

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch import model_selection as tsel
from multimodalmusig_tpu_torch.models import ctm_base as tcb, mmctm as tm
from multimodalmusig_tpu_torch.ops import solvers as tsolvers

torch.set_num_threads(2)

RTOL = 1e-10
K = (3, 2)
V = (7, 5)
# maxiter of the inference calls: long enough to converge at tol 1e-4 here
N_INFER = 30
_STATES_JIT = {}


def _jit(fn, *static):
    """One jax.jit per function, as the JAX wrappers jit it."""
    key = (fn, static)
    if key not in _STATES_JIT:
        _STATES_JIT[key] = jax.jit(fn, static_argnames=static)
    return _STATES_JIT[key]


def _corpus(rng, D, vocab=V, high=9):
    return [rng.integers(0, high, (D, v)).astype(np.float64) for v in vocab]


def _docs(dense):
    """Dense (D, V_m) counts as X[doc][modality] sparse matrices."""
    per_m = [dense_to_sparse(x) for x in dense]
    return [[per_m[m][d] for m in range(len(dense))] for d in range(dense[0].shape[0])]


def _cfgs(K, V, D):
    return (jm.MMCTMConfig(K=tuple(K), V=tuple(V), D=D, dtype=jnp.float64),
            tm.MMCTMConfig(K=tuple(K), V=tuple(V), D=D, dtype=torch.float64))


def _lane0(x):
    return x[0].numpy()


@pytest.fixture(scope="module")
def trained():
    """A JAX MMCTM fit for 12 iterations on 10 documents (one with an empty
    modality), as a JAX wrapper and as the port's (`mmctm_from_state`), and
    new documents for inference (one with an empty modality)."""
    rng = np.random.default_rng(21)
    Xtrain = _corpus(rng, 10)
    Xtrain[1][3] = 0.0
    jcfg, _ = _cfgs(K, V, 10)
    state = jm.init_with_alpha(jax.random.key(4), jcfg, tuple(jnp.asarray(x) for x in Xtrain),
                               [0.1, 0.2])
    fitted = _jit(jm.fit, "config", "maxiter", "tol")(
        state, tuple(jnp.asarray(x) for x in Xtrain), jcfg, maxiter=12, tol=0.0)
    state = fitted.state
    docs = _docs(Xtrain)
    jmodel = jm.MMCTM(list(K), [0.1, 0.2], list(V), docs, dtype=jnp.float64)
    jmodel.state = state
    tmodel = mt.mmctm_from_state(state, docs, device="cpu")
    Xnew = _corpus(rng, 6)
    Xnew[0][2] = 0.0
    Xother = _corpus(rng, 10)  # other counts of the training documents
    Xother[1][0] = 0.0
    arrays = {"mu": np.asarray(state.mu), "Sigma": np.asarray(state.Sigma),
              "invSigma": np.asarray(state.invSigma),
              "gamma": [np.asarray(g) for g in state.gamma]}
    return dict(js=state, ts=tmodel.state, jmodel=jmodel, tmodel=tmodel, Xnew=Xnew,
                docs_new=_docs(Xnew), docs_other=_docs(Xother), arrays=arrays,
                elbo=float(fitted.elbo))


def _fresh(Xnp, K, V, alpha, seed):
    """A fresh JAX state for inference and the same state in the port."""
    jcfg, tcfg = _cfgs(K, V, Xnp[0].shape[0])
    Xj = tuple(jnp.asarray(x) for x in Xnp)
    state = jm.init_with_alpha(jax.random.key(seed), jcfg, Xj, alpha)
    return jcfg, tcfg, Xj, tm.counts_tensors(Xnp, tcfg, "cpu"), state, \
        mt.state_from_numpy(state, device="cpu")


def _assert_same_result(got, want, rtol=RTOL):
    n = int(want.n_iters)
    assert int(got.n_iters[0]) == n and bool(got.converged[0]) == bool(want.converged)
    np.testing.assert_allclose(got.ll_history[0, :n].numpy(), np.asarray(want.ll_history[:n]),
                               rtol=rtol)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=rtol)
    for name in ("lam", "nu", "zeta", "mu", "Sigma", "invSigma"):
        np.testing.assert_allclose(_lane0(getattr(got.state, name)),
                                   np.asarray(getattr(want.state, name)), rtol=rtol,
                                   atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# The *_states functions against JAX and the numpy oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fit_gaussian", [False, True])
def test_transform_states_match_jax_and_the_oracle(trained, fit_gaussian):
    from oracle_mmctm import oracle_transform

    f = trained
    jcfg, tcfg, Xj, Xt, js0, ts0 = _fresh(f["Xnew"], K, V, [0.1, 0.2], 5)
    want = _jit(jm.transform_states, "config", "maxiter", "tol", "fit_gaussian")(
        f["js"], js0, Xj, jcfg, maxiter=8, tol=0.0, fit_gaussian=fit_gaussian)
    got = tm.transform_states(f["ts"], ts0, Xt, tcfg, maxiter=8, tol=0.0,
                              fit_gaussian=fit_gaussian)
    _assert_same_result(got, want)
    so, ll_hist = oracle_transform(f["Xnew"], f["arrays"], list(K), 8, fit_gaussian=fit_gaussian)
    np.testing.assert_allclose(got.ll_history[0].numpy(), ll_hist, rtol=1e-8)
    np.testing.assert_allclose(_lane0(got.state.lam), so["lam"], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(_lane0(got.state.nu), so["nu"], rtol=1e-7)
    if not fit_gaussian:  # the trained Σ, and Σ⁻¹ re-inverted from it
        np.testing.assert_array_equal(_lane0(got.state.Sigma), f["arrays"]["Sigma"])
        np.testing.assert_allclose(_lane0(got.state.invSigma),
                                   np.linalg.inv(f["arrays"]["Sigma"]), rtol=1e-9)


def test_fit_heldout_states_match_jax_and_the_oracle(trained):
    from oracle_mmctm import oracle_fit_heldout

    f = trained
    jcfg, tcfg, Xj, Xt, js0, ts0 = _fresh(f["Xnew"], K, V, [0.1, 0.2], 6)
    want = _jit(jm.fit_heldout_states, "config", "maxiter", "tol")(
        f["js"], js0, Xj, jcfg, maxiter=8, tol=0.0)
    got = tm.fit_heldout_states(f["ts"], ts0, Xt, tcfg, maxiter=8, tol=0.0)
    _assert_same_result(got, want)
    so, ll_hist = oracle_fit_heldout(f["Xnew"], f["arrays"], list(K), 8)
    np.testing.assert_allclose(got.ll_history[0].numpy(), ll_hist, rtol=1e-8)
    np.testing.assert_allclose(_lane0(got.state.lam), so["lam"], rtol=1e-7, atol=1e-10)
    # the globals are the trained ones, bit for bit
    for name in ("mu", "Sigma", "invSigma", "alpha"):
        assert torch.equal(getattr(got.state, name), getattr(f["ts"], name)), name


@pytest.mark.parametrize("m", [0, 1])
def test_predict_modality_eta_states_match_jax_and_the_oracle(trained, m):
    from oracle_mmctm import oracle_predict_eta

    f = trained
    obsM = [i for i in range(2) if i != m]
    Xobs = [f["Xnew"][i] for i in obsM]
    jcfg, tcfg = _cfgs(K, V, 6)
    ocj, oct_, Xj, Xt, js0, ts0 = _fresh(Xobs, [K[i] for i in obsM], [V[i] for i in obsM],
                                         [0.1], 7)
    eta_j, obs_j, conv_j = _jit(jm.predict_modality_eta_states, "m", "config", "obs_config",
                                "maxiter", "tol")(f["js"], js0, Xj, m, jcfg, ocj, maxiter=8,
                                                  tol=0.0)
    eta_t, obs_t, conv_t = tm.predict_modality_eta_states(f["ts"], ts0, Xt, m, tcfg, oct_,
                                                          maxiter=8, tol=0.0)
    assert eta_t.shape == (1, 6, K[m]) and bool(conv_t[0]) == bool(conv_j)
    np.testing.assert_allclose(_lane0(eta_t), np.asarray(eta_j), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(_lane0(obs_t.lam), np.asarray(obs_j.lam), rtol=RTOL, atol=1e-12)
    eta_o, so, _ = oracle_predict_eta(Xobs, m, f["arrays"], list(K), 8)
    np.testing.assert_allclose(_lane0(eta_t), eta_o, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(_lane0(obs_t.lam), so["lam"], rtol=1e-7, atol=1e-10)


# ---------------------------------------------------------------------------
# The wrappers and the top-level dispatch
# ---------------------------------------------------------------------------


def _assert_same_model(got, want, rtol=RTOL):
    assert isinstance(got, mt.MMCTM) and got.device.type == "cpu"
    assert got.converged == want.converged
    np.testing.assert_allclose(got.ll, want.ll, rtol=rtol)
    np.testing.assert_allclose(got.elbo, want.elbo, rtol=rtol)
    for name in ("mu", "Sigma", "invSigma"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=rtol,
                                   atol=1e-12, err_msg=name)
    for d in range(want.D):
        for m in range(want.M):
            np.testing.assert_allclose(got.props[d][m], want.props[d][m], rtol=rtol)


@pytest.mark.parametrize("fit_gaussian", [False, True])
def test_transform_wrapper_matches_jax(trained, fit_gaussian):
    f = trained
    want = jmm.transform(f["jmodel"], f["docs_new"], maxiter=N_INFER, fit_gaussian=fit_gaussian)
    got = mt.transform(f["tmodel"], f["docs_new"], maxiter=N_INFER, fit_gaussian=fit_gaussian)
    _assert_same_model(got, want)
    if not fit_gaussian:  # the trained μ, Σ and Σ⁻¹ themselves
        for name in ("mu", "Sigma", "invSigma"):
            assert torch.equal(getattr(got.state, name), getattr(f["ts"], name))


def test_fit_heldout_wrapper_matches_jax(trained):
    f = trained
    want = jmm.fit_heldout(f["docs_new"], f["jmodel"], maxiter=N_INFER)
    got = mt.fit_heldout(f["docs_new"], f["tmodel"], maxiter=N_INFER)
    _assert_same_model(got, want)
    assert got.converged


@pytest.mark.parametrize("m", [1, 2])
def test_predict_modality_eta_wrapper_matches_jax(trained, m):
    f = trained
    Xobs = [[doc[i] for i in range(2) if i != m - 1] for doc in f["docs_new"]]
    want = jmm.predict_modality_eta(Xobs, m, f["jmodel"], maxiter=N_INFER)
    got = mt.predict_modality_eta(Xobs, m, f["tmodel"], maxiter=N_INFER)
    assert len(got) == 6 and got[0].shape == (K[m - 1],)
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=RTOL, atol=1e-12)


def test_predict_warns_when_not_converged_and_checks_m(trained):
    f = trained
    Xobs = [[doc[1]] for doc in f["docs_new"]]
    with pytest.warns(UserWarning, match="model not converged."):
        mt.predict_modality_eta(Xobs, 1, f["tmodel"], maxiter=3)
    with pytest.raises(ValueError, match="1-based"):
        mt.predict_modality_eta(Xobs, 0, f["tmodel"])


def test_elbo_and_loglikelihood_dispatch_match_jax(trained):
    """calculate_elbo, calculate_loglikelihoods and
    calculate_docmodality_loglikelihoods, on the model's counts and on
    others, with the NaN of a document with no counts in a modality. The
    ELBO is held against the one the JAX fit computed for its final state."""
    f = trained
    np.testing.assert_allclose(mt.calculate_elbo(f["tmodel"]), f["elbo"], rtol=RTOL)
    for args in ((), (f["docs_other"],)):
        np.testing.assert_allclose(mt.calculate_loglikelihoods(*args, f["tmodel"]),
                                   jmm.calculate_loglikelihoods(*args, f["jmodel"]), rtol=RTOL)
        got = mt.calculate_docmodality_loglikelihoods(*args, f["tmodel"])
        want = jmm.calculate_docmodality_loglikelihoods(*args, f["jmodel"])
        assert got.shape == want.shape and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)
        nan_doc = 0 if args else 3  # no counts in the second modality
        assert np.isnan(got[nan_doc, 1]) and np.isfinite(got).sum() == got.size - 1


def test_docmodality_loglikelihoods_functions_match_jax(trained):
    f = trained
    Xt = tm.counts_tensors(f["Xnew"], _cfgs(K, V, 6)[1], "cpu")
    cfg = f["tmodel"].config
    got = tm.docmodality_loglikelihoods(Xt, tm.props_from(f["ts"].lam[:, :6], cfg),
                                        tm.phi_point(f["ts"].gamma))
    want = jm.docmodality_loglikelihoods(tuple(jnp.asarray(x) for x in f["Xnew"]),
                                         jm.props_from(f["js"].lam[:6], f["jmodel"].config),
                                         jm.phi_point(f["js"].gamma))
    assert got.shape == (1, 6, 2) and bool(torch.isnan(got[0, 2, 0]))
    np.testing.assert_allclose(_lane0(got), np.asarray(want), rtol=RTOL, equal_nan=True)
    one = tm.doc_modality_loglikelihood(Xt[0][1], tm.props_from(f["ts"].lam, cfg)[0][:, 1],
                                        tm.phi_point(f["ts"].gamma)[0])
    np.testing.assert_allclose(float(one[0]), float(jm.doc_modality_loglikelihood(
        jnp.asarray(f["Xnew"][0][1]), jm.props_from(f["js"].lam, f["jmodel"].config)[0][1],
        jm.phi_point(f["js"].gamma)[0])), rtol=RTOL)


def test_lda_and_ilda_models_raise_naming_their_port():
    """The dispatch takes this package's models: a JAX package model raises
    the reference's TypeError, naming its type; the port's LDA and ILDA
    have no predict_modality_eta and no per-modality lls, as in the JAX
    dispatch."""
    lda = jmm.LDA(2, 0.1, 0.1, [np.array([[1, 2], [3, 1]])])
    ilda = jmm.ILDA(2, 0.1, [0.1, 0.1], np.array([[1, 1], [2, 1], [1, 2]]),
                    [np.array([[1, 2], [3, 1]])])
    for model in (lda, ilda):
        for call in (lambda: mt.transform(model, []), lambda: mt.fit_heldout([], model),
                     lambda: mt.predict_modality_eta([], 1, model),
                     lambda: mt.calculate_elbo(model),
                     lambda: mt.calculate_loglikelihood(model),
                     lambda: mt.calculate_loglikelihoods(model),
                     lambda: mt.calculate_docmodality_loglikelihoods(model)):
            with pytest.raises(TypeError, match=f"for <class '{type(model).__module__}"):
                call()
    port = (mt.LDA(2, 0.1, 0.1, [np.array([[1, 2], [3, 1]])], device="cpu"),
            mt.ILDA(2, 0.1, [0.1, 0.1], np.array([[1, 1], [2, 1], [1, 2]]),
                    [np.array([[1, 2], [3, 1]])], device="cpu"))
    for model in port:
        for call in (lambda: mt.predict_modality_eta([], 1, model),
                     lambda: mt.calculate_loglikelihoods(model),
                     lambda: mt.calculate_docmodality_loglikelihoods(model)):
            with pytest.raises(TypeError, match=type(model).__name__):
                call()
    with pytest.raises(TypeError, match="no transform"):
        mt.transform(object(), [])


def test_jax_checkpoint_loads_and_transforms_as_in_jax(trained, tmp_path):
    f = trained
    path = str(tmp_path / "model.npz")
    jio.save_model(path, f["jmodel"])
    loaded = mt.load_model(path, device="cpu")
    assert loaded.config.dtype == torch.float64
    want = jmm.transform(f["jmodel"], f["docs_new"], maxiter=N_INFER)
    _assert_same_model(mt.transform(loaded, f["docs_new"], maxiter=N_INFER), want)


def test_the_wrapper_of_fit_mmctm_restarts_serves_all_three_calls(trained):
    """A two-stage fit on the CPU, then the three calls on its wrapper, each
    held against the JAX call on a JAX wrapper holding the same state."""
    f = trained
    model = mt.fit_mmctm_restarts(list(K), [0.1, 0.2], f["jmodel"].X, V=list(V), restarts=2,
                                  maxiter=15, dtype=torch.float64, device="cpu")
    jmodel = jm.MMCTM(list(K), model.alpha, list(V), model.X, dtype=jnp.float64)
    jmodel.state = jm.MMCTMState(**{
        name: (tuple(jnp.asarray(x[0].numpy()) for x in v) if isinstance(v, tuple)
               else jnp.asarray(v[0].numpy()))
        for name, v in model.state._asdict().items()})
    _assert_same_model(mt.transform(model, f["docs_new"], maxiter=N_INFER),
                       jmm.transform(jmodel, f["docs_new"], maxiter=N_INFER))
    _assert_same_model(mt.fit_heldout(f["docs_new"], model, maxiter=N_INFER),
                       jmm.fit_heldout(f["docs_new"], jmodel, maxiter=N_INFER))
    Xobs = [[doc[0]] for doc in f["docs_new"]]
    np.testing.assert_allclose(np.stack(mt.predict_modality_eta(Xobs, 2, model, maxiter=N_INFER)),
                               np.stack(jmm.predict_modality_eta(Xobs, 2, jmodel,
                                                                 maxiter=N_INFER)),
                               rtol=RTOL, atol=1e-12)


# ---------------------------------------------------------------------------
# autoα, updateΣ = false and the α solver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("autoalpha, update_sigma", [(True, True), (False, False)])
def test_fit_options_match_jax_trajectories(autoalpha, update_sigma):
    rng = np.random.default_rng(5)
    Xnp = _corpus(rng, 8)
    jcfg, tcfg, Xj, Xt, js0, ts0 = _fresh(Xnp, K, V, [0.3, 0.05], 2)
    want = _jit(jm.fit, "config", "maxiter", "tol", "autoalpha", "update_sigma")(
        js0, Xj, jcfg, maxiter=12, tol=0.0, autoalpha=autoalpha, update_sigma=update_sigma)
    got = tm.fit(ts0, Xt, tcfg, maxiter=12, tol=0.0, autoalpha=autoalpha,
                 update_sigma=update_sigma)
    _assert_same_result(got, want)
    np.testing.assert_allclose(_lane0(got.state.alpha), np.asarray(want.state.alpha), rtol=RTOL)
    for a, b in zip(got.state.gamma, want.state.gamma):
        np.testing.assert_allclose(_lane0(a), np.asarray(b), rtol=RTOL)
    if autoalpha:
        assert not np.allclose(_lane0(got.state.alpha), [0.3, 0.05])
    if not update_sigma:
        assert torch.equal(got.state.Sigma[0], torch.eye(5, dtype=torch.float64))


def test_maximize_alpha_matches_jax():
    rng = np.random.default_rng(8)
    jfn = jax.jit(jax.vmap(jsolvers.maximize_alpha, in_axes=(0, 0, None, None)),
                  static_argnums=(2, 3))
    for Kt, Vt in ((7, 96), (2, 5), (7, 1)):
        gammas = rng.uniform(0.05, 80.0, (6, Kt, Vt))
        S = (jax.scipy.special.digamma(gammas)
             - jax.scipy.special.digamma(gammas.sum(-1, keepdims=True))).sum((-2, -1))
        alpha0 = np.array([0.1, 1e-9, 0.5, 3.0, 20.0, 0.01])
        want = np.asarray(jfn(jnp.asarray(alpha0), S, Kt, Vt))
        got = tsolvers.maximize_alpha(torch.as_tensor(alpha0), torch.as_tensor(np.array(S)),
                                      Kt, Vt)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
        assert (got >= tsolvers.ALPHA_LOWER_BOUND).all()


def test_update_alpha_matches_jax(trained):
    f = trained
    want = jm.update_alpha(f["js"], f["jmodel"].config).alpha
    got = tm.update_alpha(f["ts"], f["tmodel"].config).alpha
    assert got.shape == (1, 2)
    np.testing.assert_allclose(_lane0(got), np.asarray(want), rtol=1e-12)


# ---------------------------------------------------------------------------
# The wrapper's surface, CTM, verbose loops and host reads
# ---------------------------------------------------------------------------


def test_wrapper_fields_and_aliases_match_jax(trained):
    f = trained
    got, want = f["tmodel"], f["jmodel"]
    assert got.N == want.N
    for m in range(2):
        np.testing.assert_allclose(np.stack(got.Elnphi[m]), np.stack(want.Elnphi[m]), rtol=RTOL)
    for d in range(want.D):
        for m in range(2):
            np.testing.assert_allclose(got.theta[d][m], want.theta[d][m], rtol=RTOL)
    cls = mt.MMCTM
    assert (cls.μ, cls.Σ, cls.invΣ, cls.α, cls.ϕ, cls.γ, cls.Elnϕ, cls.λ, cls.ν, cls.ζ,
            cls.θ) == (cls.mu, cls.Sigma, cls.invSigma, cls.alpha, cls.phi, cls.gamma,
                       cls.Elnphi, cls.lam, cls.nu, cls.zeta, cls.theta)
    np.testing.assert_array_equal(got.μ, got.mu)
    assert cls.fit_ is cls.fit


def test_wrapper_fit_takes_the_julia_keywords_and_prints_as_jax(trained, capsys):
    f = trained
    docs = f["jmodel"].X
    jmodel = jm.MMCTM(list(K), [0.1, 0.2], list(V), docs, dtype=jnp.float64, seed=3)
    tmodel = mt.mmctm_from_state(jmodel.state, docs, device="cpu")
    want = jmodel.fit(maxiter=12, tol=0.0, verbose=False, **{"autoα": True, "updateΣ": False})
    capsys.readouterr()
    got = tmodel.fit_(maxiter=12, tol=0.0, **{"autoα": True, "updateΣ": False})
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("inner-solver budgets: {'lambda_n_iter': None")
    assert len(lines) == 13 and lines[12].startswith("12\tLog-likelihoods: [")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(tmodel.alpha, jmodel.alpha, rtol=RTOL)
    with pytest.raises(TypeError, match="unexpected kwargs"):
        tmodel.fit(maxiter=1, verbose=False, bogus=1)


def test_ctm_matches_jax():
    rng = np.random.default_rng(3)
    docs = _docs(_corpus(rng, 6, vocab=(9,)))
    jmodel = jmm.CTM(3, 0.1, docs, dtype=jnp.float64)
    tmodel = mt.CTM(3, 0.1, 9, docs, dtype=torch.float64, device="cpu")
    assert isinstance(tmodel, mt.MMCTM) and (tmodel.K, tmodel.V) == ([3], [9])
    tmodel.state = mt.state_from_numpy(jmodel.state, device="cpu")
    want = jmodel.fit(maxiter=12, tol=0.0, verbose=False)
    got = tmodel.fit(maxiter=12, tol=0.0, verbose=False)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    _assert_same_model(mt.fit_heldout(docs[:3], tmodel, maxiter=N_INFER),
                       jmm.fit_heldout(docs[:3], jmodel, maxiter=N_INFER))
    with pytest.raises(TypeError, match="CTM"):
        mt.CTM(3, 0.1)


class _HostReads:
    """Counts the tensor methods that read a value on the host."""

    NAMES = ("__bool__", "item", "tolist", "numpy", "__float__", "__int__")

    def __init__(self, monkeypatch):
        self.count = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, _name=name, **k):
                self.count[_name] += 1
                return _orig(t, *a, **k)
            monkeypatch.setattr(torch.Tensor, name, counted)


def test_cavi_steps_read_nothing_on_the_host(trained, monkeypatch):
    """A fit step with autoα and without the Σ update, and 8 iterations of
    each inference loop: no host read but the loop's own, one `tolist` at
    its start, one `done.all()` per DONE_CHECK_EVERY iterations and the
    (n_iters, done) read at its end."""
    f = trained
    jcfg, tcfg, Xj, Xt, js0, ts0 = _fresh(f["Xnew"], K, V, [0.1, 0.2], 5)
    step = tm.fit_step_fn(Xt, tcb.counts_per_doc(Xt), tcfg, autoalpha=True, update_sigma=False)
    reads = _HostReads(monkeypatch)
    step(ts0)
    assert sum(reads.count.values()) == 0, reads.count
    assert tcb.DONE_CHECK_EVERY == 8
    tm.transform_states(f["ts"], ts0, Xt, tcfg, maxiter=8, tol=0.0)
    tm.fit_heldout_states(f["ts"], ts0, Xt, tcfg, maxiter=8, tol=0.0)
    assert reads.count == {"__bool__": 2, "item": 0, "tolist": 2, "numpy": 4, "__float__": 0,
                           "__int__": 0}, reads.count


def test_verbose_inference_prints_one_line_per_iteration(trained, capsys):
    f = trained
    heldout = mt.fit_heldout(f["docs_new"], f["tmodel"], maxiter=N_INFER, verbose=True)
    lines = capsys.readouterr().out.splitlines()
    n = len(lines)
    assert 10 < n < N_INFER and heldout.converged
    assert [line.split("\t")[0] for line in lines] == [str(i + 1) for i in range(n)]
    assert all("\tLog-likelihoods: [" in line for line in lines)
    np.testing.assert_allclose([float(v) for v in lines[-1].split("[")[1].strip("]").split()],
                               heldout.ll, rtol=1e-6)


# ---------------------------------------------------------------------------
# model_selection
# ---------------------------------------------------------------------------


def test_train_test_split_gives_the_jax_documents():
    docs = [[np.array([[d + 1, 1]])] for d in range(23)]
    for frac, seed in ((0.2, 0), (0.5, 3), (0.01, 7)):
        got = tsel.train_test_split_docs(docs, frac, seed)
        want = jsel.train_test_split_docs(docs, frac, seed)
        for g, w in zip(got, want):
            assert [int(doc[0][0, 0]) for doc in g] == [int(doc[0][0, 0]) for doc in w]
    assert mt.train_test_split_docs is tsel.train_test_split_docs


def test_heldout_ll_curve_equals_jax_from_an_injected_init(monkeypatch):
    """restarts=1: each candidate is one MMCTM fit. The port's MMCTM is
    handed the JAX init state of the same candidate and seed, so both
    curves come from the same computation."""
    rng = np.random.default_rng(9)
    docs = _docs(_corpus(rng, 14, vocab=(6, 4)))
    train, test = tsel.train_test_split_docs(docs, 0.25, seed=1)

    class Injected(tm.MMCTM):
        def __init__(self, k, alpha, V, X, seed=0, dtype=None, device=None):
            super().__init__(k, alpha, V, X, seed=seed, dtype=dtype, device=device)
            init = jm.MMCTM(k, alpha, V, X, seed=seed, dtype=jnp.float64).state
            self.state = mt.state_from_numpy(init, device=device)

    monkeypatch.setattr(tsel, "MMCTM", Injected)
    kw = dict(restarts=1, maxiter=15, heldout_maxiter=N_INFER, seed=2)
    want = jsel.heldout_ll_curve([(2, 2), (3, 1)], train, test, [0.1, 0.1], **kw)
    got = tsel.heldout_ll_curve([(2, 2), (3, 1)], train, test, [0.1, 0.1], dtype=torch.float64,
                                device="cpu", **kw)
    assert [k for k, _ in got] == [k for k, _ in want] == [[2, 2], [3, 1]]
    np.testing.assert_allclose([ll for _, ll in got], [ll for _, ll in want], rtol=RTOL)


def test_select_k_mmctm_runs_the_restart_path_on_the_cpu():
    """restarts > 1 goes through fit_mmctm_restarts on the device asked for;
    the choice is the best mean held-out ll of the curve."""
    rng = np.random.default_rng(2)
    docs = _docs(_corpus(rng, 12, vocab=(6, 4)))
    best, curve = mt.select_k_mmctm([(1, 1), (2, 2)], docs, [0.1, 0.1], restarts=2, maxiter=20,
                                    heldout_maxiter=10, compact_schedule=(5,),
                                    dtype=torch.float64, device="cpu")
    assert [k for k, _ in curve] == [[1, 1], [2, 2]] and np.isfinite([ll for _, ll in curve]).all()
    assert best == max(curve, key=lambda kv: np.mean(kv[1]))[0]
