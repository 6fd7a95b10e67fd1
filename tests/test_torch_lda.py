"""The PyTorch LDA against the JAX package's, in float64, from the same
(injected) states.

On a 24-document slice of the BRCA-EU SNV counts (V = 96) at K = 3: one
CAVI step, a 30-iteration fit from the JAX init and the ELBO, at rtol 1e-10
(the trajectory standard of tests/test_trajectory_oracle.py) on the ll
history, γ, λ and the ELBO; `transform` and `fit_heldout` of one trained
state handed to both packages; `fit_lda_restarts` from the JAX inits (every
lane's history, the lane the JAX selection picks) and cut every way the fit
can be cut; the float64 re-scores at rtol 1e-12; checkpoints cross-loaded
both ways; the top-level dispatch; and the TPU θ kernel
(tools/pallas_experiments/theta_kernel.py:83, interpret mode) fed LDA's
(E[ln θ], E[ln β]), against the JAX `update_gamma`/`update_lambda` moments at
the float32 bound of tests/test_pallas_kernels.py (rtol 2e-5, atol 1e-4).
The two packages differ only in summation order, all at f64 rounding."""

import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu import calculate_elbo as jax_calculate_elbo
from multimodalmusig_tpu import calculate_loglikelihood as jax_calculate_loglikelihood
from multimodalmusig_tpu.models import lda as jl
from multimodalmusig_tpu.parallel import rescore as jrescore
from multimodalmusig_tpu.parallel import restarts as jr
from multimodalmusig_tpu.utils import io as jio

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import lda as tl
from multimodalmusig_tpu_torch.parallel import restarts as tr
from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

from conftest import requires_brca_data

pytestmark = requires_brca_data

torch.set_num_threads(2)

RTOL = 1e-10
D, K, V, ALPHA, ETA = 24, 3, 96, 0.1, 0.1
JIT_FIT = jax.jit(jl.fit, static_argnames=("config", "maxiter", "tol"))


def brca_snv_slice(n_docs=D):
    """The first `n_docs` documents of the BRCA-EU SNV counts: dense (D, 96)
    float64 counts, the sparse documents and the 96 term names."""
    counts, terms = read_counts_tsv(brca_counts_path(BRCA_FILES[0]))[:2]
    X = counts.T[:n_docs].astype(np.float64)
    return X, [mt.make_count_matrix(X[d]) for d in range(n_docs)], terms


def port_state(jax_state):
    return mt.lda_state_from_numpy(jax_state, device="cpu")


def assert_states_close(got, want, rtol=RTOL, lane=0, atol=1e-12):
    """Every field of lane `lane` of a port state against an unbatched JAX
    state (tuples of per-feature fields flattened)."""
    for name in type(got)._fields:
        g, w = getattr(got, name), getattr(want, name)
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            np.testing.assert_allclose(a[lane].numpy(), np.asarray(b), rtol=rtol, atol=atol,
                                       err_msg=name)


@pytest.fixture(scope="module")
def f():
    """The JAX model of the slice, its init and its 30-iteration fit."""
    X, docs, _ = brca_snv_slice()
    jmodel = jl.LDA(K, ALPHA, ETA, V, docs)
    assert jmodel.config.dtype == jnp.float64
    fit = JIT_FIT(jmodel.state, jmodel.Xdense, jmodel.config, maxiter=30, tol=0.0)
    tcfg = tl.LDAConfig(K=K, V=V, D=D, alpha=ALPHA, eta=ETA, dtype=torch.float64)
    return dict(X=X, docs=docs, jmodel=jmodel, fit=fit, tcfg=tcfg, Xt=torch.as_tensor(X))


def test_fit_step_matches_jax(f):
    """One CAVI step from the 30-iteration state: every field and the ll."""
    js = f["fit"].state
    want_state, want_ll = jax.jit(lambda s: jl._fit_step(s, f["jmodel"].Xdense,
                                                         f["jmodel"].config))(js)
    got_state, got_ll = tl.fit_step_fn(f["Xt"], f["tcfg"])(port_state(js))
    np.testing.assert_allclose(float(got_ll[0]), float(want_ll), rtol=RTOL)
    assert_states_close(got_state, want_state)


def test_fit_matches_jax(f):
    """30 iterations from the JAX init: the ll history, the final state and
    the ELBO."""
    want = f["fit"]
    got = tl.fit(port_state(f["jmodel"].state), f["Xt"], f["tcfg"], maxiter=30, tol=0.0)
    assert got.ll_history.shape == (1, 30) and got.ll.shape == (1,)
    assert int(got.n_iters[0]) == int(want.n_iters) == 30
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=RTOL)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=RTOL)
    assert_states_close(got.state, want.state)


def test_converged_fit_stops_where_jax_stops(f):
    """tol 1e-3: the reference's rule after iteration 10 ends both fits at
    the same iteration, converged."""
    want = JIT_FIT(f["jmodel"].state, f["jmodel"].Xdense, f["jmodel"].config, maxiter=60,
                   tol=1e-3)
    got = tl.fit(port_state(f["jmodel"].state), f["Xt"], f["tcfg"], maxiter=60, tol=1e-3)
    n = int(want.n_iters)
    assert 10 < n < 60 and int(got.n_iters[0]) == n
    assert bool(got.converged[0]) and bool(want.converged)
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=RTOL)


def test_calculate_elbo_matches_jax(f):
    js = f["fit"].state
    got = tl.calculate_elbo(port_state(js), f["Xt"], f["tcfg"])
    np.testing.assert_allclose(float(got[0]), float(jl.calculate_elbo(js, f["jmodel"].Xdense,
                                                                       f["jmodel"].config)),
                               rtol=RTOL)


def test_updates_with_a_given_phi_match_jax(f):
    """update_gamma and update_lambda contract a ϕ handed to them, and
    unsmoothed_update_phi records ln β, as the JAX functions do."""
    js, jcfg = f["fit"].state, f["jmodel"].config
    rng = np.random.default_rng(0)
    phi = rng.dirichlet(np.ones(K), (D, V))
    st = port_state(js)
    tphi = torch.as_tensor(phi)[None]
    g = tl.update_gamma(st, f["Xt"], f["tcfg"], tphi)
    lam = tl.update_lambda(st, f["Xt"], f["tcfg"], tphi)
    jphi = jnp.asarray(phi)
    assert_states_close(g, jl.update_gamma(js, f["jmodel"].Xdense, jcfg, jphi))
    assert_states_close(lam, jl.update_lambda(js, f["jmodel"].Xdense, jcfg, jphi))
    u = tl.unsmoothed_update_phi(st, tl.beta_point(st))
    assert_states_close(u, jl.unsmoothed_update_phi(js, jl.beta_point(js)))
    np.testing.assert_allclose(tl.reconstruct_phi(u)[0].numpy(),
                               np.asarray(jl.reconstruct_phi(jl.unsmoothed_update_phi(
                                   js, jl.beta_point(js)))), rtol=RTOL)


@pytest.fixture(scope="module")
def trained(f):
    """One trained state in both packages' wrappers, and new documents (the
    next 16 of the cohort) to infer."""
    _, new_docs, _ = brca_snv_slice(D + 16)
    jmodel = jl.LDA(K, ALPHA, ETA, V, f["docs"])
    jmodel.state = f["fit"].state
    tmodel = mt.lda_from_state(f["fit"].state, ALPHA, ETA, f["docs"], device="cpu")
    return dict(jmodel=jmodel, tmodel=tmodel, new=new_docs[D:])


def test_transform_matches_jax(trained):
    """θ of the new documents (K, D_new) with the trained β frozen."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both packages warn alike when a fold-in stops early
        want = jl.transform(trained["jmodel"], trained["new"], maxiter=40)
        got = mt.transform(trained["tmodel"], trained["new"], maxiter=40)
    assert got.shape == (K, 16)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL)


def test_transform_states_match_jax(trained, f):
    """The fold-in's whole result: the ll history, γ and the ELBO of
    {trained topics, new γ, inference ϕ}."""
    jm = trained["jmodel"]
    jcfg = jm.config.__class__(K=K, V=V, D=16, alpha=ALPHA, eta=ETA, dtype=jnp.float64)
    Xnew = np.stack([np.bincount(d[:, 0] - 1, weights=d[:, 1], minlength=V)
                     for d in trained["new"]])
    fresh = jl.init(jax.random.key(0), jcfg)
    _, want = jax.jit(jl.transform_states, static_argnames=("config", "maxiter", "tol"))(
        jm.state, fresh, jnp.asarray(Xnew), jcfg, maxiter=25, tol=0.0)
    tcfg = tl.LDAConfig(K=K, V=V, D=16, alpha=ALPHA, eta=ETA, dtype=torch.float64)
    theta, got = tl.transform_states(port_state(jm.state), port_state(fresh),
                                     torch.as_tensor(Xnew), tcfg, maxiter=25, tol=0.0)
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=RTOL)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=RTOL)
    assert_states_close(got.state, want.state)
    np.testing.assert_allclose(theta[0].numpy().sum(-1), 1.0, rtol=1e-12)


def test_fit_heldout_matches_jax(trained):
    want = jl.fit_heldout(trained["new"], trained["jmodel"], maxiter=30)
    got = mt.fit_heldout(trained["new"], trained["tmodel"], maxiter=30)
    assert isinstance(got, tl.LDA) and got.D == 16
    np.testing.assert_allclose(got.ll, want.ll, rtol=RTOL)
    np.testing.assert_allclose(got.elbo, want.elbo, rtol=RTOL)
    assert got.converged == want.converged
    assert_states_close(got.state, want.state)


@pytest.fixture(scope="module")
def restarts(f):
    """Four JAX-initialized lanes fit 20 iterations each by the JAX package,
    and the lane its f64-rescored selection picks."""
    jcfg = f["jmodel"].config
    keys = jax.random.split(jax.random.key(7), 4)
    inits = jax.vmap(lambda k: jl.init(k, jcfg))(keys)
    lanes = [JIT_FIT(jax.tree_util.tree_map(lambda a, r=r: a[r], inits), f["jmodel"].Xdense,
                     jcfg, maxiter=20, tol=0.0) for r in range(4)]
    want = jax.tree_util.tree_map(lambda *a: np.stack([np.asarray(x) for x in a]), *lanes)
    best = jr._best_scalar_ll_lane(
        want, lambda c: jrescore.rescore_lda_f64(want.state.gamma, want.state.lam, f["X"],
                                                 lanes=c), True)
    return dict(inits=inits, want=want, best=best)


def test_rescore_matches_jax(f, restarts):
    """All lanes, a subset in its order, and a dead (NaN) lane."""
    st = restarts["want"].state
    gamma, lam = np.array(st.gamma), np.array(st.lam)
    gamma[2] = np.nan
    want = jrescore.rescore_lda_f64(gamma, lam, f["X"])
    got = mt.rescore_lda_f64(torch.as_tensor(gamma), torch.as_tensor(lam), f["X"])
    assert got.dtype == torch.float64 and bool(torch.isnan(got[2]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    sub = np.array([3, 0])
    np.testing.assert_allclose(
        mt.rescore_lda_f64(torch.as_tensor(gamma), torch.as_tensor(lam), f["X"], sub).numpy(),
        jrescore.rescore_lda_f64(gamma, lam, f["X"], lanes=sub), rtol=1e-12)


def _inject(monkeypatch, inits):
    monkeypatch.setattr(tr.lda_mod, "init",
                        lambda *a, **k: mt.lda_state_from_numpy(inits, device="cpu"))


def test_fit_lda_restarts_matches_jax_lanes_and_selection(f, restarts, monkeypatch):
    """fit_lda_restarts with the JAX inits injected: every lane's history at
    rtol 1e-10 and the lane the JAX package's f64-rescored selection
    picks, with its ll."""
    _inject(monkeypatch, restarts["inits"])
    want = restarts["want"]
    model = mt.fit_lda_restarts(K, ALPHA, ETA, f["docs"], V=V, restarts=4, maxiter=20, tol=0.0,
                                dtype=torch.float64, device="cpu")
    res = model.restart_result
    np.testing.assert_allclose(res.ll_history.numpy(), want.ll_history, rtol=RTOL)
    np.testing.assert_allclose(res.elbo.numpy(), want.elbo, rtol=RTOL)
    best = restarts["best"]
    assert len(set(np.round(want.ll, 6))) == 4  # four distinct optima: the pick is a real one
    np.testing.assert_allclose(model.ll, want.ll[best], rtol=RTOL)
    np.testing.assert_allclose(model.lam, want.state.lam[best], rtol=1e-8, atol=1e-10)
    assert isinstance(model, tl.LDA) and isinstance(model.ll, float)


@pytest.fixture(scope="module")
def uncut(f):
    """Eight lanes to tol 1e-4, uncut: they end at different iterations."""
    return mt.fit_lda_restarts(K, ALPHA, ETA, f["docs"], V=V, restarts=8, maxiter=60, tol=1e-4,
                               seed=3, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("cut", [dict(chunk_iters=7), dict(compact_schedule=(12, 6)),
                                 dict(compact_schedule="auto", pilot_restarts=3)],
                         ids=["chunk_iters", "pinned", "auto"])
def test_cut_fits_give_each_lanes_uncut_result(f, uncut, cut):
    want = uncut.restart_result
    assert len(set(want.n_iters.tolist())) > 1
    model = mt.fit_lda_restarts(K, ALPHA, ETA, f["docs"], V=V, restarts=8, maxiter=60, tol=1e-4,
                                seed=3, dtype=torch.float64, device="cpu", **cut)
    got = model.restart_result
    np.testing.assert_array_equal(got.n_iters.numpy(), want.n_iters.numpy())
    np.testing.assert_allclose(got.ll_history.numpy(), want.ll_history.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.elbo.numpy(), want.elbo.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.state.lam.numpy(), want.state.lam.numpy(), rtol=1e-12)
    assert model.ll == uncut.ll
    if cut.get("compact_schedule") == "auto":
        assert model.compact_info["pilot_restarts"] == 3


def test_selection_without_rescore_reads_the_in_fit_lls(f, uncut):
    model = mt.fit_lda_restarts(K, ALPHA, ETA, f["docs"], V=V, restarts=8, maxiter=60, tol=1e-4,
                                seed=3, dtype=torch.float64, device="cpu", rescore_f64=False)
    ll = uncut.restart_result.ll.numpy()
    assert model.ll == float(ll.max()) == uncut.ll


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_load(f, tmp_path, writer):
    """A checkpoint 5 iterations into a fit, written by one package, loads
    in the other with the state equal to the last bit, and the resumed fits
    agree at rtol 1e-10."""
    path = str(tmp_path / "lda.npz")
    jm = jl.LDA(K, ALPHA, ETA, V, f["docs"])
    if writer == "jax":
        jm.fit(maxiter=5, verbose=False)
        jio.save_model(path, jm)
    else:
        pm = mt.LDA(K, ALPHA, ETA, V, f["docs"], dtype=torch.float64, device="cpu")
        pm.state = port_state(jm.state)
        pm.fit(maxiter=5, verbose=False)
        mt.save_model(path, pm)
    jl2, pl2 = jio.load_model(path), mt.load_model(path, device="cpu")
    assert type(pl2) is tl.LDA and pl2.config == f["tcfg"]
    assert (pl2.ll, pl2.elbo, pl2.converged) == (jl2.ll, jl2.elbo, jl2.converged)
    for name in tl.LDAState._fields:
        np.testing.assert_array_equal(getattr(pl2.state, name)[0].numpy(),
                                      np.asarray(getattr(jl2.state, name)))
    for a, b in zip(pl2.X, jl2.X):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pl2.fit(maxiter=3, verbose=False), jl2.fit(maxiter=3, verbose=False),
                               rtol=RTOL)


def test_dispatch_matches_jax(trained):
    """calculate_elbo and calculate_loglikelihood of `(model)` and `(X,
    model)` (X over the model's documents) give the JAX values; transform and fit_heldout reach the LDA
    functions; predict_modality_eta raises TypeError, as in the JAX
    package."""
    jm, tm = trained["jmodel"], trained["tmodel"]
    np.testing.assert_allclose(mt.calculate_elbo(tm), jax_calculate_elbo(jm), rtol=RTOL)
    np.testing.assert_allclose(mt.calculate_loglikelihood(tm), jax_calculate_loglikelihood(jm),
                               rtol=RTOL)
    docs = [d.copy() for d in trained["jmodel"].X]  # (X, model): the model's θ, these counts
    docs[0][:, 1] *= 2
    np.testing.assert_allclose(mt.calculate_loglikelihood(docs, tm),
                               jax_calculate_loglikelihood(docs, jm), rtol=RTOL)
    assert isinstance(mt.fit_heldout(trained["new"], tm, maxiter=3), tl.LDA)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert mt.transform(tm, trained["new"], maxiter=3).shape == (K, 16)
    with pytest.raises(TypeError, match="no predict_modality_eta"):
        mt.predict_modality_eta(trained["new"], 1, tm)


def test_tpu_theta_kernel_gives_the_lda_moments(f):
    """The TPU θ kernel in interpret mode, fed the (E[ln θ], E[ln β]) of a
    ϕ-update 30 iterations into the fit, in float32: its sumθ is the JAX
    update_gamma's γ − α and its scatter the JAX update_lambda's (λ − η)ᵀ,
    both computed in float64; the port's plain version agrees with it."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    from pallas_experiments.theta_kernel import theta_moments_fused as jax_kernel

    from multimodalmusig_tpu_torch.ops import theta_kernel as tk

    js = jl.update_phi(f["fit"].state)
    jcfg = f["jmodel"].config
    a, b = np.asarray(js.Elntheta_pre), np.asarray(js.logw_pre)
    assert a.min() < -8 and b.min() < -10  # LDA's logits: digammas of γ ≥ α, rare terms
    X32 = f["X"].astype(np.float32)
    st, sc = jax_kernel(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                        jnp.asarray(X32), tile_d=16, interpret=True)
    want_st = np.asarray(jl.update_gamma(js, f["jmodel"].Xdense, jcfg).gamma) - ALPHA
    want_sc = (np.asarray(jl.update_lambda(js, f["jmodel"].Xdense, jcfg).lam) - ETA).T
    np.testing.assert_allclose(np.asarray(st), want_st, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(sc), want_sc, rtol=2e-5, atol=1e-4)
    pst, psc = tk.theta_moments_fused_plain(*(torch.tensor(x)[None] for x in (a, b)),
                                            torch.as_tensor(f["X"]))
    np.testing.assert_allclose(pst[0].numpy(), want_st, rtol=1e-12)
    np.testing.assert_allclose(psc[0].numpy(), want_sc, rtol=1e-12)


def test_wrapper_fields_match_the_jax_wrapper(f):
    """The R = 1 wrapper: the reference's constructor and field surface, in
    the reference's orientation; with the JAX init injected its fit is the
    JAX fit."""
    want = f["jmodel"]
    got = mt.LDA(K, ALPHA, ETA, f["docs"], dtype=torch.float64, device="cpu")
    for name in ("K", "D", "V", "N", "alpha", "eta", "α", "η"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.lam.shape == (V, K) and got.gamma.shape == (K, D) and got.theta.shape == (K, D)
    assert len(got.phi) == D and got.phi[0].shape == (K, len(f["docs"][0]))
    np.testing.assert_allclose(got.phi[0].sum(axis=0), 1.0, rtol=1e-12)
    got.state = port_state(want.state)
    history = got.fit(maxiter=30, tol=0.0, verbose=False)
    np.testing.assert_allclose(history, np.asarray(f["fit"].ll_history), rtol=RTOL)
    want.state = f["fit"].state
    for name in ("lam", "beta", "Elnbeta", "gamma", "theta", "Elntheta", "λ", "β", "Elnβ", "γ",
                 "θ", "Elnθ"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-8,
                                   atol=1e-10, err_msg=name)
    for a, b in zip(got.ϕ, want.ϕ):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    assert got.ll == history[-1] and np.isfinite(got.elbo) and "fitted" in repr(got)
    assert got.fit_ == got.fit


def test_verbose_fit_prints_the_jax_label(f, capsys):
    """One line per iteration, "<i>\\tLog-likelihood: <ll>", the JAX LDA
    loop's label."""
    model = mt.LDA(K, ALPHA, ETA, f["docs"], dtype=torch.float64, device="cpu")
    model.fit(maxiter=4, tol=0.0)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 and lines[3].startswith("4\tLog-likelihood: -")


def test_lda_state_from_numpy_batched_and_unbatched(restarts):
    inits = restarts["inits"]
    batched = mt.lda_state_from_numpy(inits, device="cpu", dtype=torch.float32)
    one = mt.lda_state_from_numpy(jax.tree_util.tree_map(lambda a: a[1], inits), device="cpu")
    assert batched.lam.shape == (4, V, K) and batched.lam.dtype == torch.float32
    assert one.gamma.shape == (1, D, K) and one.gamma.dtype == torch.float64
    np.testing.assert_array_equal(one.lam[0].numpy(), batched.lam[1].double().numpy())
    with pytest.raises(ValueError, match="one lane"):
        mt.lda_from_state(inits, ALPHA, ETA, [np.array([[1, 2]])] * D, device="cpu")
