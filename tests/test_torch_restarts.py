"""Restart fitting in the PyTorch port: R lanes as a leading dimension
against the JAX package's vmapped restarts, restart selection against the
JAX selectors, and the dead-lane (non-finite ll) rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import mmctm as jm
from multimodalmusig_tpu.parallel import restarts as jr

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base as tcb, mmctm as tm
from multimodalmusig_tpu_torch.parallel import restarts as tr

from conftest import requires_brca_data

torch.set_num_threads(2)


@requires_brca_data
def test_restart_lanes_match_jax_vmapped_restarts_on_brca():
    """3 JAX-initialized lanes, f64, maxiter 20 at tol 3e-3: per-lane ll
    history and n_iters equal the JAX fit_restarts_from_keys on the same keys
    (lanes converge at different iterations, so lane freezing is exercised)."""
    from multimodalmusig_tpu_torch.utils.data import BRCA_FILES, brca_counts_path
    from multimodalmusig_tpu_torch.utils.fast_tsv import read_counts_tsv

    Xnp = [read_counts_tsv(brca_counts_path(f))[0].T for f in BRCA_FILES]
    V, D = tuple(x.shape[1] for x in Xnp), Xnp[0].shape[0]
    jcfg = jm.MMCTMConfig(K=(7, 7), V=V, D=D, dtype=jnp.float64)
    tcfg = tm.MMCTMConfig(K=(7, 7), V=V, D=D, dtype=torch.float64)
    Xj = tuple(jnp.asarray(x) for x in Xnp)
    alpha = jnp.asarray([0.1, 0.1])
    keys = jax.random.split(jax.random.key(11), 3)
    want = jr.fit_restarts_from_keys(keys, Xj, jcfg, alpha, maxiter=20, tol=3e-3)
    inits = jax.vmap(lambda k: jm.init_with_alpha(k, jcfg, Xj, alpha))(keys)
    got = mt.fit_restarts_from_states(mt.state_from_numpy(inits, device="cpu"), Xnp, tcfg,
                                      maxiter=20, tol=3e-3)

    assert len(set(np.asarray(want.n_iters).tolist())) > 1
    np.testing.assert_array_equal(got.n_iters.numpy(), np.asarray(want.n_iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.ll_history.numpy(), np.asarray(want.ll_history), rtol=1e-9)
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll), rtol=1e-9)
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(want.elbo), rtol=1e-9)


def _random_lls(seed, R=12, M=3, n_nan=2):
    rng = np.random.default_rng(seed)
    ll = -rng.uniform(2.0, 5.0, (R, M)).round(2)  # rounding makes ties
    ll[rng.choice(R, n_nan, replace=False), rng.integers(0, M, n_nan)] = np.nan
    ll[rng.integers(0, R), 0] = -np.inf
    return ll


@pytest.mark.parametrize("seed", range(5))
def test_selection_matches_jax(seed):
    ll = _random_lls(seed)
    t = torch.as_tensor(ll)
    assert int(tr.pick_optimal_restart(t)) == int(jr.pick_optimal_restart(jnp.asarray(ll)))
    np.testing.assert_array_equal(
        tr.pick_optimal_modality_restarts(t).numpy(),
        np.asarray(jr.pick_optimal_modality_restarts(jnp.asarray(ll))),
    )


def test_dense_rank_matches_jax():
    v = np.array([3.0, 1.0, 3.0, 2.0, np.inf, 1.0, 7.5])
    np.testing.assert_array_equal(
        tr.dense_rank(torch.as_tensor(v)).numpy(), np.asarray(jr.dense_rank(jnp.asarray(v)))
    )


def _tiny(R, seed=0):
    rng = np.random.default_rng(seed)
    Xnp = [rng.integers(0, 9, (5, 6)).astype(np.float64), rng.integers(0, 9, (5, 4)).astype(np.float64)]
    cfg = tm.MMCTMConfig(K=(2, 2), V=(6, 4), D=5, dtype=torch.float64)
    Xt = tm.counts_tensors(Xnp, cfg, "cpu")
    state = tm.init_with_alpha(torch.Generator().manual_seed(seed), cfg, Xt, [0.1, 0.1], restarts=R,
                               device="cpu")
    return cfg, Xt, state


def test_dead_lane_stops_reports_not_converged_and_is_never_picked():
    cfg, Xt, state = _tiny(3)
    lam = state.lam.clone()
    lam[1, 0, 0] = torch.nan  # lane 1 goes non-finite in its first iteration
    res = tr.fit_restarts_from_states(state._replace(lam=lam), Xt, cfg, maxiter=25, tol=0.0)
    assert res.n_iters.tolist() == [25, 1, 25]
    assert res.converged.tolist() == [False, False, False]
    assert not torch.isfinite(res.ll[1]).any() and torch.isfinite(res.ll[[0, 2]]).all()
    assert int(tr.pick_optimal_restart(res.ll)) != 1
    assert 1 not in tr.pick_optimal_modality_restarts(res.ll).tolist()
    # the healthy lanes are untouched by their dead neighbour
    alone = tr.fit_restarts_from_states(tr.lane(state, 2), Xt, cfg, maxiter=25, tol=0.0)
    assert torch.equal(alone.ll_history[0], res.ll_history[2])


def test_when_the_loop_notices_done_lanes_does_not_change_results(monkeypatch):
    """Finished lanes are frozen, so reading done.all() every iteration or
    every DONE_CHECK_EVERY iterations gives bit-identical results."""
    cfg, Xt, state = _tiny(4, seed=2)
    base = tr.fit_restarts_from_states(state, Xt, cfg, maxiter=60, tol=1e-4)
    assert base.converged.all() and len(set(base.n_iters.tolist())) > 1
    monkeypatch.setattr(tcb, "DONE_CHECK_EVERY", 1)
    every = tr.fit_restarts_from_states(state, Xt, cfg, maxiter=60, tol=1e-4)
    for a, b in zip(base[1:], every[1:]):
        assert torch.equal(a, b)
    for a, b in zip(base.state, every.state):
        assert all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b)


def test_fit_restarts_takes_a_seed_or_a_generator():
    cfg, Xt, _ = _tiny(1)
    a = tr.fit_restarts(7, Xt, cfg, [0.1, 0.1], restarts=2, maxiter=12, tol=0.0, device="cpu")
    b = tr.fit_restarts(torch.Generator().manual_seed(7), [x.numpy() for x in Xt], cfg,
                        [0.1, 0.1], restarts=2, maxiter=12, tol=0.0, device="cpu")
    assert torch.equal(a.ll_history, b.ll_history)
    assert a.ll.shape == (2, 2) and a.ll_history.shape == (2, 12, 2)
    assert torch.isfinite(a.elbo).all()
