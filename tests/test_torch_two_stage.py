"""The two-stage best-of-N MMCTM path of the PyTorch port against the JAX
package: the float64 re-score and the host pickers, the compaction
schedule, the compacted stage-1 fit, two-stage selection and
`fit_mmctm_restarts`.

Tolerances: the re-score and the pickers, rtol 1e-12 (two exact float64
evaluations of the same formula); fits in float64 from injected JAX inits,
rtol 1e-10 (the trajectory standard of tests/test_trajectory_oracle.py);
the compacted fit against the port's unchunked fit, bit for bit (finished
lanes are frozen, and on the CPU a lane's arithmetic does not depend on the
batch it sits in)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import mmctm as jm
from multimodalmusig_tpu.parallel import rescore as jrs
from multimodalmusig_tpu.parallel import restarts as jr

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.parallel import rescore as trs
from multimodalmusig_tpu_torch.parallel import restarts as tr

torch.set_num_threads(2)

RTOL = 1e-10
R, MAXITER = 6, 80
SCHEDULE = (25, 10)


@pytest.fixture(scope="module")
def small():
    """24 documents of Poisson counts over V = (10, 8), K = (2, 2): lanes
    converge between 24 and 60 iterations at tol 1e-4."""
    rng = np.random.default_rng(0)
    D, V, K = 24, (10, 8), (2, 2)
    X = [rng.poisson(rng.gamma(1.0, 3.0, (D, 1)) * rng.dirichlet(np.ones(v), D) * 5)
         .astype(np.float64) for v in V]
    jcfg = jm.MMCTMConfig(K=K, V=V, D=D, dtype=jnp.float64)
    tcfg = tm.MMCTMConfig(K=K, V=V, D=D, dtype=torch.float64)
    Xj = tuple(jnp.asarray(x) for x in X)
    alpha = jnp.asarray([0.1, 0.1])

    def inits(key, n):
        return mt.state_from_numpy(jax.vmap(lambda k: jm.init_with_alpha(k, jcfg, Xj, alpha))(
            jax.random.split(key, n)), device="cpu")

    return dict(X=X, Xj=Xj, jcfg=jcfg, tcfg=tcfg, alpha=alpha, inits=inits)


def _lanes_equal(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            assert _lanes_equal(x, y)
        else:
            assert torch.equal(x, y) or (torch.isnan(x).any() and torch.equal(
                torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))
    return True


# ---------------------------------------------------------------------------
# re-score and pickers
# ---------------------------------------------------------------------------


def test_rescore_matches_jax_with_a_dead_lane_and_a_lane_subset(small):
    rng = np.random.default_rng(1)
    cfg = small["tcfg"]
    lam = rng.standard_normal((5, cfg.D, cfg.MK)) * 2.0
    lam[3] = np.nan  # a dead lane
    gamma = tuple(rng.uniform(0.1, 9.0, (5, k, v)) for k, v in zip(cfg.K, cfg.V))
    want = jrs.rescore_mmctm_f64(lam, gamma, small["X"], small["jcfg"])
    got = trs.rescore_mmctm_f64(torch.as_tensor(lam), tuple(map(torch.as_tensor, gamma)),
                                small["X"], cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    assert np.isnan(got[3].numpy()).all() and np.isfinite(got[[0, 1, 2, 4]].numpy()).all()
    lanes = np.array([4, 0, 2])
    sub = trs.rescore_mmctm_f64(torch.as_tensor(lam), tuple(map(torch.as_tensor, gamma)),
                                small["X"], cfg, lanes=lanes)
    np.testing.assert_allclose(sub.numpy(), jrs.rescore_mmctm_f64(
        lam, gamma, small["X"], small["jcfg"], lanes=lanes), rtol=1e-12)


@pytest.mark.parametrize("seed", range(4))
def test_pickers_and_shortlist_match_the_jax_host_versions(seed):
    """The torch pickers, which read the f64 re-scores where they were
    computed, pick what the JAX package's NumPy pickers pick, ties (the
    scores are rounded to 1e-3) and a dead lane included."""
    rng = np.random.default_rng(seed)
    ll = -rng.uniform(2.0, 2.05, (15, 2)).round(3)
    ll[rng.integers(0, 15), rng.integers(0, 2)] = np.nan
    llt = torch.as_tensor(ll)
    assert int(tr.pick_optimal_restart(llt)) == jrs.pick_optimal_restart_np(ll)
    np.testing.assert_array_equal(tr.pick_optimal_modality_restarts(llt).numpy(),
                                  jrs.pick_optimal_modality_restarts_np(ll))
    for m in range(2):  # |ll| with a dead lane as +inf, as the rank pick reads it
        vals = np.where(np.isfinite(ll[:, m]), np.abs(ll[:, m]), np.inf)
        np.testing.assert_array_equal(tr.dense_rank(torch.as_tensor(vals)).numpy(),
                                      jrs.dense_rank_np(vals))
    np.testing.assert_array_equal(trs.shortlist_lanes(ll), jrs.shortlist_lanes(ll))
    np.testing.assert_array_equal(trs.shortlist_lanes(ll, window=1e-3),
                                  jrs.shortlist_lanes(ll, window=1e-3))


@pytest.mark.parametrize("case", [
    dict(),
    dict(production_restarts=1000),
    dict(max_boundaries=1),
    dict(boundary_cost_lane_iters=500.0, margin_z=0.0),
    dict(maxiter=150),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_suggest_compact_schedule_matches_jax(seed, case):
    """Seeded iteration counts shaped like BRCA's (a median near 120 and a
    long tail), at R = 100 and R = 1000."""
    rng = np.random.default_rng(seed)
    for n in (100, 1000):
        iters = np.minimum(40 + rng.gamma(2.0, 45.0, n).astype(np.int64), 400)
        got = tr.suggest_compact_schedule(iters, **case)
        assert got == jr.suggest_compact_schedule(iters, **case)
        assert all(isinstance(c, int) and c > 0 for c in got)
    assert tr.suggest_compact_schedule(np.full(50, 30)) == ()
    assert tr.suggest_compact_schedule([]) == ()


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def test_compacted_fit_equals_the_unchunked_fit_lane_for_lane(small):
    cfg = small["tcfg"]
    kw = dict(restarts=R, maxiter=MAXITER, tol=1e-4, device="cpu")
    whole = tr.fit_restarts(3, small["X"], cfg, [0.1, 0.1], **kw)
    parts = tr.fit_restarts(3, small["X"], cfg, [0.1, 0.1], compact_schedule=SCHEDULE, **kw)
    it = whole.n_iters.numpy()
    # the schedule cuts through the distribution: some lanes end in each phase
    assert (it <= 25).any() and ((it > 25) & (it <= 35)).any() and (it > 35).any()
    assert (it == MAXITER).any()  # a lane that never converged leaves at maxiter
    assert _lanes_equal(whole, parts)


def test_compaction_takes_a_dead_lane_out_at_the_first_boundary(small):
    """A lane whose ll goes non-finite in its first iteration stops, leaves
    the batch at the first boundary as not converged, and the other lanes
    end as in the unchunked fit."""
    cfg = small["tcfg"]
    X = tm.counts_tensors(small["X"], cfg, "cpu")
    state = tm.init_with_alpha(torch.Generator().manual_seed(3), cfg, X, [0.1, 0.1], restarts=4,
                               device="cpu")
    lam = state.lam.clone()
    lam[2, 0, 0] = torch.nan
    state = state._replace(lam=lam)
    whole = tr.fit_restarts_from_states(state, X, cfg, maxiter=MAXITER, tol=1e-4)
    parts = tr.fit_restarts_from_states(state, X, cfg, maxiter=MAXITER, tol=1e-4,
                                        compact_schedule=(5,))
    assert parts.n_iters[2] == 1 and not parts.converged[2]
    assert not torch.isfinite(parts.ll[2]).any() and torch.isfinite(parts.ll[[0, 1, 3]]).all()
    assert _lanes_equal(whole, parts)


def test_compacted_fit_matches_jax(small):
    key = jax.random.key(3)
    want = jr.fit_restarts(key, small["Xj"], small["jcfg"], small["alpha"], restarts=R,
                           maxiter=MAXITER, tol=1e-4, compact_schedule=SCHEDULE)
    got = tr.fit_restarts_from_states(small["inits"](key, R), small["X"], small["tcfg"],
                                      maxiter=MAXITER, tol=1e-4, compact_schedule=SCHEDULE)
    np.testing.assert_array_equal(got.n_iters.numpy(), np.asarray(want.n_iters))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.ll_history.numpy(), np.asarray(want.ll_history), rtol=RTOL)
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(want.elbo), rtol=RTOL)
    np.testing.assert_allclose(got.state.lam.numpy(), np.asarray(want.state.lam),
                               rtol=1e-8, atol=1e-10)


def test_run_cavi_from_resumes_in_any_cut(small):
    """Two calls of run_cavi_from (12 iterations, then the rest) give the
    carry of one run_cavi."""
    from multimodalmusig_tpu_torch.models import ctm_base

    cfg = small["tcfg"]
    X = tm.counts_tensors(small["X"], cfg, "cpu")
    state = tm.init_with_alpha(torch.Generator().manual_seed(5), cfg, X, [0.1, 0.1], restarts=3,
                               device="cpu")
    step = tm.fit_step_fn(X, ctm_base.counts_per_doc(X), cfg)
    whole = ctm_base.run_cavi(state, cfg, 40, 1e-4, step)
    carry = ctm_base.make_cavi_carry(state, cfg, 40)
    carry = ctm_base.run_cavi_from(carry, 40, 1e-4, step, max_new_iters=12)
    assert carry[2].tolist() == [12, 12, 12] and not carry[3].any()
    carry = ctm_base.run_cavi_from(carry, 40, 1e-4, step)
    assert _lanes_equal(whole, carry)
    mixed = (carry[0], carry[1], torch.tensor([12, 13, 40]), torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError, match="different iterations"):
        ctm_base.run_cavi_from(mixed, 40, 1e-4, step)


# ---------------------------------------------------------------------------
# two-stage selection
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_stage(small):
    """The JAX two_stage_fit, and the port's from the JAX stage-1 inits."""
    key = jax.random.key(3)
    kw = dict(maxiter=MAXITER, stage1_tol=1e-4, stage2_tol=1e-5)
    jinfo, tinfo = {}, {}
    want = jr.two_stage_fit(key, small["Xj"], small["jcfg"], small["alpha"], restarts=R,
                            selection_info=jinfo, **kw)
    state1 = small["inits"](jax.random.split(key)[0], R)
    fits = []

    def spy(state, *a, **k):
        fits.append(state)
        return fit(state, *a, **k)

    fit = tm.fit
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "fit", spy)
        got = tr.two_stage_fit_from_states(state1, small["X"], small["tcfg"], [0.1, 0.1],
                                           selection_info=tinfo, **kw)
    graft = fits[-1]  # the stage-2 initial state
    return dict(want=want, got=got, jinfo=jinfo, tinfo=tinfo, state1=state1, kw=kw,
                graft=graft)


def test_two_stage_picks_the_jax_winners_and_refits_them(two_stage):
    (jbest, js1, js2, jidx), (tbest, ts1, ts2, tidx) = two_stage["want"], two_stage["got"]
    np.testing.assert_allclose(ts1.ll_history.numpy(), np.asarray(js1.ll_history), rtol=RTOL)
    winners = two_stage["tinfo"]["stage1_winners"]
    np.testing.assert_array_equal(winners, two_stage["jinfo"]["stage1_winners"])
    np.testing.assert_allclose(two_stage["tinfo"]["stage1_winner_ll"],
                               two_stage["jinfo"]["stage1_winner_ll"], rtol=1e-12)
    assert tidx == int(jidx)
    # the graft: stage 2 starts from the winners' γ and E[ln ϕ]
    graft = two_stage["graft"]
    for m, w in enumerate(winners):
        for field in ("gamma", "Elnphi"):
            np.testing.assert_allclose(getattr(graft, field)[m][0].numpy(),
                                       np.asarray(getattr(js1.state, field)[m][w]), rtol=RTOL)
    np.testing.assert_array_equal(ts2.n_iters.numpy(), np.asarray(js2.n_iters))
    np.testing.assert_allclose(ts2.ll_history.numpy(), np.asarray(js2.ll_history), rtol=RTOL)
    np.testing.assert_allclose(tbest.ll[0].numpy(), np.asarray(jbest.ll), rtol=RTOL)
    np.testing.assert_allclose(tbest.elbo[0].numpy(), np.asarray(jbest.elbo), rtol=RTOL)


def test_stage2_restarts_are_duplicates(small, two_stage):
    """The graft overwrites the only random part of an init, so stage-2
    lanes are identical whatever their generator, and the pick is lane 0."""
    best, _, s2, idx = tr.two_stage_fit_from_states(
        two_stage["state1"], small["X"], small["tcfg"], [0.1, 0.1], stage2_restarts=3,
        generator=torch.Generator().manual_seed(99), **two_stage["kw"])
    assert idx == 0
    for r in (1, 2):
        assert _lanes_equal(tr.lane(s2, 0), tr.lane(s2, r))
    assert torch.equal(s2.ll_history[0], two_stage["got"][2].ll_history[0])


def test_rescore_off_picks_by_the_in_fit_lls(small, two_stage):
    info = {}
    _, s1, s2, idx = tr.two_stage_fit_from_states(
        two_stage["state1"], small["X"], small["tcfg"], [0.1, 0.1], rescore_f64=False,
        selection_info=info, **two_stage["kw"])
    np.testing.assert_array_equal(info["stage1_winners"],
                                  tr.pick_optimal_modality_restarts(s1.ll).numpy())
    np.testing.assert_array_equal(info["stage1_winner_ll"],
                                  s1.ll.numpy()[info["stage1_winners"], [0, 1]])
    assert idx == int(tr.pick_optimal_restart(s2.ll))


def test_compacted_stage1_gives_the_same_two_stage_result(small, two_stage):
    got = tr.two_stage_fit_from_states(two_stage["state1"], small["X"], small["tcfg"],
                                       [0.1, 0.1], compact_schedule=(15,), **two_stage["kw"])
    assert _lanes_equal(got[1], two_stage["got"][1])
    assert _lanes_equal(got[0], two_stage["got"][0])


def test_fit_mmctm_restarts_returns_the_selected_model(small, capsys):
    docs = [[mt.make_count_matrix(small["X"][m][d]) for m in range(2)]
            for d in range(small["tcfg"].D)]
    model = mt.fit_mmctm_restarts([2, 2], [0.1, 0.1], docs, restarts=4, maxiter=40, seed=8,
                                  dtype=torch.float64, verbose=True, device="cpu")
    best, s1, _, _ = tr.two_stage_fit(8, small["X"], small["tcfg"], [0.1, 0.1], restarts=4,
                                      maxiter=40, device="cpu")
    assert "Modality optimal model log-likelihoods:" in capsys.readouterr().out
    assert model.ll == best.ll[0].tolist() and model.elbo == float(best.elbo[0])
    assert len(model.ll_history) == int(best.n_iters[0])
    assert model.ll_history[-1] == model.ll
    np.testing.assert_array_equal(model.stage1_ll, s1.ll.numpy())
    assert torch.equal(model.restart_result.ll_history, s1.ll_history)
    assert torch.equal(model.state.lam, best.state.lam)
    assert model.converged == bool(best.converged[0])
