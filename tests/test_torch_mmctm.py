"""The PyTorch MMCTM against the JAX package's, in float64, from the same
(injected) states.

Each CAVI step function is compared on a mid-fit state at rtol 1e-10; whole
fits are compared at the trajectory standard of
tests/test_trajectory_oracle.py: rtol 1e-10 on the reference fixture and
rtol 1e-9 over 5 iterations of the BRCA-EU cohort. The two sides differ only
in summation order (batched matmuls here, einsums there) and in the Σ
inverse (cholesky_ex + triangular solve here, an unrolled Cholesky there),
all at f64 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import ctm_base as jcb, mmctm as jm
from multimodalmusig_tpu.utils.formatting import sparse_to_dense

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base as tcb, mmctm as tm

from conftest import requires_brca_data

torch.set_num_threads(2)

RTOL = 1e-10


def _configs(K, Xnp):
    V = tuple(x.shape[1] for x in Xnp)
    D = Xnp[0].shape[0]
    return (
        jm.MMCTMConfig(K=tuple(K), V=V, D=D, dtype=jnp.float64),
        tm.MMCTMConfig(K=tuple(K), V=V, D=D, dtype=torch.float64),
    )


def _lane0(x):
    return np.asarray(x[0])


@pytest.fixture(scope="module")
def mid_fit():
    """A random corpus, the JAX state after 3 CAVI iterations (so λ, Σ and γ
    are far from their init), and the same state in the port."""
    rng = np.random.default_rng(7)
    K = (3, 2)
    Xnp = [rng.integers(0, 9, (6, 7)).astype(np.float64),
           rng.integers(0, 9, (6, 5)).astype(np.float64)]
    Xnp[1][0] = 0.0  # a document with an empty modality
    jcfg, tcfg = _configs(K, Xnp)
    Xj = tuple(jnp.asarray(x) for x in Xnp)
    state = jm.init_with_alpha(jax.random.key(1), jcfg, Xj, [0.1, 0.2])
    state = jax.jit(jm.fit, static_argnames=("config", "maxiter", "tol"))(
        state, Xj, jcfg, maxiter=3, tol=0.0
    ).state
    Xt = tm.counts_tensors(Xnp, tcfg, "cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, Xj=Xj, Xt=Xt, js=state,
                ts=mt.state_from_numpy(state), Nj=jcb.counts_per_doc(Xj),
                Nt=tcb.counts_per_doc(Xt))


def test_theta_moments_matches_jax(mid_fit):
    f = mid_fit
    st_j, sc_j = jcb.theta_moments(f["js"].lam, jm.smoothed_logw(f["js"]), f["Xj"], f["jcfg"])
    st_t, sc_t = tcb.theta_moments(f["ts"].lam, tm.smoothed_logw(f["ts"]), f["Xt"], f["tcfg"])
    np.testing.assert_allclose(_lane0(st_t), np.asarray(st_j), rtol=RTOL)
    for a, b in zip(sc_t, sc_j):
        np.testing.assert_allclose(_lane0(a), np.asarray(b), rtol=RTOL)


def test_solve_eta_matches_jax(mid_fit):
    f = mid_fit
    st_j, _ = jcb.theta_moments(f["js"].lam, jm.smoothed_logw(f["js"]), f["Xj"], f["jcfg"])
    js, ts = f["js"], f["ts"]
    want = jcb.solve_eta(js.lam, js.nu, f["Nj"], st_j, js.mu, js.invSigma, f["jcfg"])
    got = tcb.solve_eta(ts.lam, ts.nu, f["Nt"], torch.as_tensor(np.array(st_j))[None],
                        ts.mu, ts.invSigma, f["tcfg"])
    for name, g, w in zip(("zeta", "nu", "lam"), got, want):
        np.testing.assert_allclose(_lane0(g), np.asarray(w), rtol=RTOL, atol=1e-12, err_msg=name)


def test_m_step_matches_jax(mid_fit):
    """update_mu, update_Sigma (Σ and its inverse) and update_gamma."""
    f = mid_fit
    _, sc_j = jcb.theta_moments(f["js"].lam, jm.smoothed_logw(f["js"]), f["Xj"], f["jcfg"])
    js = jm.update_Sigma(jm.update_mu(f["js"]), f["jcfg"])
    js = jm.update_gamma(js, f["Xj"], f["jcfg"], scatter=sc_j)
    ts = tm.update_Sigma(tm.update_mu(f["ts"]), f["tcfg"])
    ts = tm.update_gamma(ts, f["tcfg"], tuple(torch.as_tensor(np.array(s))[None] for s in sc_j))
    np.testing.assert_allclose(_lane0(ts.mu), np.asarray(js.mu), rtol=RTOL)
    np.testing.assert_allclose(_lane0(ts.Sigma), np.asarray(js.Sigma), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(_lane0(ts.invSigma), np.asarray(js.invSigma), rtol=1e-9, atol=1e-11)
    for name in ("gamma", "Elnphi"):
        for a, b in zip(getattr(ts, name), getattr(js, name)):
            np.testing.assert_allclose(_lane0(a), np.asarray(b), rtol=RTOL, err_msg=name)


def test_loglikelihoods_match_jax(mid_fit):
    f = mid_fit
    want = jm.modality_loglikelihoods(
        f["Xj"], jm.props_from(f["js"].lam, f["jcfg"]), jm.phi_point(f["js"].gamma)
    )
    got = tm.modality_loglikelihoods(
        f["Xt"], tm.props_from(f["ts"].lam, f["tcfg"]), tm.phi_point(f["ts"].gamma)
    )
    np.testing.assert_allclose(_lane0(got), np.asarray(want), rtol=RTOL)


def test_elbo_and_its_terms_match_jax(mid_fit):
    f = mid_fit
    want = jm.elbo_terms(f["js"], f["Xj"], f["Nj"], f["jcfg"])
    got = tm.elbo_terms(f["ts"], f["Xt"], f["Nt"], f["tcfg"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name][0]), float(want[name]), rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(
        float(tm.calculate_elbo(f["ts"], f["Xt"], f["Nt"], f["tcfg"])[0]),
        float(jm.calculate_elbo(f["js"], f["Xj"], f["Nj"], f["jcfg"])), rtol=RTOL,
    )


def _fit_both(Xnp, K, alpha, maxiter, tol, seed=0):
    jcfg, tcfg = _configs(K, Xnp)
    Xj = tuple(jnp.asarray(x) for x in Xnp)
    state = jm.init_with_alpha(jax.random.key(seed), jcfg, Xj, alpha)
    want = jax.jit(jm.fit, static_argnames=("config", "maxiter", "tol"))(
        state, Xj, jcfg, maxiter=maxiter, tol=tol
    )
    got = tm.fit(mt.state_from_numpy(state), tm.counts_tensors(Xnp, tcfg, "cpu"), tcfg,
                 maxiter=maxiter, tol=tol)
    return got, want


def _assert_same_fit(got, want, rtol):
    n = int(want.n_iters)
    assert int(got.n_iters[0]) == n
    assert bool(got.converged[0]) == bool(want.converged)
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=rtol)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=rtol)
    np.testing.assert_allclose(_lane0(got.ll), np.asarray(want.ll), rtol=rtol)
    np.testing.assert_allclose(_lane0(got.state.lam), np.asarray(want.state.lam), rtol=1e-8, atol=1e-10)


def test_fit_matches_jax_on_the_reference_fixture(mmctm_fixture):
    """The reference's hand-built corpus (test/mmctm.jl:4-33), converging
    after 14 iterations at tol 1e-2 on both sides."""
    X = mmctm_fixture["X"]
    K = mmctm_fixture["K"]
    Xnp = [sparse_to_dense([d[m] for d in X], max(int(d[m][:, 0].max()) for d in X))
           for m in range(len(K))]
    got, want = _fit_both(Xnp, K, mmctm_fixture["alpha"], maxiter=30, tol=1e-2)
    assert bool(want.converged) and 10 < int(want.n_iters) < 30
    _assert_same_fit(got, want, RTOL)


@requires_brca_data
def test_fit_matches_jax_on_brca_for_five_iterations():
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
    from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

    Xnp = [read_counts_tsv(brca_counts_path(f))[0].T for f in BRCA_FILES]
    got, want = _fit_both(Xnp, (7, 7), [0.1, 0.1], maxiter=5, tol=0.0, seed=3)
    _assert_same_fit(got, want, 1e-9)


def test_wrapper_fits_and_exposes_reference_fields(mmctm_fixture):
    model = mt.MMCTM(mmctm_fixture["K"], mmctm_fixture["alpha"], mmctm_fixture["X"],
                     dtype=torch.float64, device="cpu")
    assert (model.K, model.D, model.M, model.V) == ([2, 3], 2, 2, [4, 4])
    history = model.fit(maxiter=12, tol=0.0)
    assert len(history) == 12 and len(history[0]) == 2
    assert model.ll == history[-1] and np.isfinite(model.elbo)
    for d in range(model.D):
        for m in range(model.M):
            np.testing.assert_allclose(model.props[d][m].sum(), 1.0, rtol=1e-12)
    for m in range(model.M):
        assert len(model.phi[m]) == model.K[m]
        np.testing.assert_allclose([p.sum() for p in model.phi[m]], 1.0, rtol=1e-12)
    assert model.mu.shape == (5,) and model.Sigma.shape == (5, 5) and model.alpha == [0.1, 0.1]
    assert len(model.lam) == model.D and model.lam[0].shape == (5,)
    assert "fitted" in repr(model)
    # fit resumes from the current state, as the reference's fit! does
    assert len(model.fit(maxiter=3, tol=0.0)) == 3


def test_init_random_and_document():
    rng = np.random.default_rng(0)
    Xnp = [rng.integers(0, 9, (6, 7)).astype(np.float64), rng.integers(0, 9, (6, 5)).astype(np.float64)]
    _, cfg = _configs((3, 2), Xnp)
    Xt = tm.counts_tensors(Xnp, cfg, "cpu")
    a = tm.init_with_alpha(torch.Generator().manual_seed(5), cfg, Xt, [0.1, 0.2], restarts=4)
    b = tm.init_with_alpha(torch.Generator().manual_seed(5), cfg, Xt, [0.1, 0.2], restarts=4)
    for g, K, V in zip(a.gamma, cfg.K, cfg.V):
        assert g.shape == (4, K, V) and g.min() >= 1 and g.max() <= 100
        assert not torch.equal(g[0], g[1])  # lanes draw independently
    assert all(torch.equal(x, y) for x, y in zip(a.gamma, b.gamma))
    assert torch.equal(a.alpha, torch.tensor([[0.1, 0.2]] * 4, dtype=torch.float64))
    np.testing.assert_allclose(a.zeta.numpy(), np.broadcast_to(np.array(cfg.K) * np.exp(0.5), (4, 6, 2)))
    d = tm.init(torch.Generator().manual_seed(5), cfg, Xt, restarts=3, init_method="document")
    for g, Xm in zip(d.gamma, Xt):
        for lane_g in g:
            rows = [int(np.flatnonzero((Xm.numpy() == row.numpy() - 1.0).all(axis=1))[0])
                    for row in lane_g]
            assert len(set(rows)) == len(rows)  # distinct seeding documents
    with pytest.raises(ValueError, match="init must be"):
        tm.init(torch.Generator(), cfg, Xt, init_method="bogus")


def test_state_from_numpy_batched_and_unbatched(mid_fit):
    js = mid_fit["js"]
    one = mt.state_from_numpy(js)
    batched = mt.state_from_numpy({k: np.stack([np.asarray(v)] * 2) if k not in
                                   ("gamma", "Elnphi", "logw_pre") else
                                   tuple(np.stack([np.asarray(x)] * 2) for x in v)
                                   for k, v in js._asdict().items()}, dtype=torch.float32)
    assert one.lam.shape == (1,) + tuple(js.lam.shape) and one.lam.dtype == torch.float64
    assert batched.lam.shape == (2,) + tuple(js.lam.shape) and batched.lam.dtype == torch.float32
    for name in tm.MMCTMState._fields:
        a, b = getattr(one, name), getattr(batched, name)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(y[1].double().numpy(), x[0].numpy(), rtol=1e-6, atol=1e-6)
