"""Chunked, compacted and auto-compacted fits of the PyTorch port, in
float64 on the CPU: each equals the uncut fit lane for lane, `progress`
reports what the fit's iteration counts say, the schedule derivation is the
JAX package's, and the options that exclude each other raise.

Tolerances: the cut fits against the uncut one at rtol 1e-12 (on the CPU a
lane's arithmetic does not depend on the batch it sits in, so they agree to
the last bit; 1e-12 is the JAX package's own bound, tests/test_auto_compact.py);
the derived schedule and its info equal the JAX package's exactly (the same
integer DP on the same inputs)."""

from functools import partial

import numpy as np
import pytest
import torch

from multimodalmusig_tpu.parallel import restarts as jr

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.ops import flags
from multimodalmusig_tpu_torch.parallel import restarts as tr

torch.set_num_threads(2)

R, MAXITER, SEED = 8, 40, 3
ALPHA = [0.1, 0.1]


@pytest.fixture(scope="module")
def small():
    """24 documents of Poisson counts over V = (10, 8), K = (2, 2) (the
    fixture of tests/test_torch_two_stage.py); from SEED, lanes end between
    24 iterations and maxiter."""
    rng = np.random.default_rng(0)
    D, V, K = 24, (10, 8), (2, 2)
    X = [rng.poisson(rng.gamma(1.0, 3.0, (D, 1)) * rng.dirichlet(np.ones(v), D) * 5)
         .astype(np.float64) for v in V]
    docs = [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(D)]
    features = [np.array([[v % 2 + 1, v // 2 + 1] for v in range(10)]),
                np.array([[v % 4 + 1, v // 4 + 1] for v in range(8)])]
    return dict(X=X, cfg=tm.MMCTMConfig(K=K, V=V, D=D, dtype=torch.float64), docs=docs,
                features=features, kw=dict(restarts=R, maxiter=MAXITER, device="cpu"))


@pytest.fixture(scope="module")
def whole(small):
    """The uncut best-of-8 fit."""
    return tr.fit_restarts(SEED, small["X"], small["cfg"], ALPHA, tol=1e-4, **small["kw"])


@pytest.fixture(scope="module")
def two_stage(small):
    """The uncut two-stage fit from the same seed."""
    return tr.two_stage_fit(SEED, small["X"], small["cfg"], ALPHA, **small["kw"])


IMMCTM_KW = dict(restarts=R, maxiter=MAXITER, tol=1e-4, seed=SEED, dtype=torch.float64,
                 device="cpu")


@pytest.fixture(scope="module")
def immctm_whole(small):
    """The uncut best-of-8 IMMCTM fit, SNV-like and SV-like terms factored
    into two features each."""
    return mt.fit_immctm_restarts([2, 2], ALPHA, small["features"], small["docs"], **IMMCTM_KW)


def _assert_results_equal(got, want):
    np.testing.assert_array_equal(got.n_iters.numpy(), want.n_iters.numpy())
    np.testing.assert_array_equal(got.converged.numpy(), want.converged.numpy())
    np.testing.assert_allclose(got.ll_history.numpy(), want.ll_history.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.elbo.numpy(), want.elbo.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got.state.lam.numpy(), want.state.lam.numpy(), rtol=1e-12,
                               atol=1e-14)
    for g, w in zip(got.state.gamma, want.state.gamma):  # IMMCTM: one more level, [m][i]
        for a, b in zip(*((x,) if torch.is_tensor(x) else x for x in (g, w))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def _boundary_iterations(chunk_iters, compact_schedule):
    """The iteration count of the running lanes at each boundary before the
    last report."""
    if chunk_iters is not None:
        return [min(c, MAXITER) for c in range(chunk_iters, MAXITER + chunk_iters, chunk_iters)]
    return list(np.cumsum(compact_schedule))


@pytest.mark.parametrize("cut", [dict(chunk_iters=7), dict(compact_schedule=(20, 9))],
                         ids=["chunk_iters=7", "schedule=(20, 9)"])
def test_cut_fits_equal_the_uncut_fit_and_report_progress(small, whole, cut):
    """`fit_restarts` cut every 7 iterations (the last chunk ragged at
    maxiter, 35 → 40, with lanes that end there) or at (20, 9) equals the
    uncut fit lane for lane. `progress` never goes down, agrees with the
    result's iteration counts at each boundary and ends at (R, R)."""
    seen = []
    got = tr.fit_restarts(SEED, small["X"], small["cfg"], ALPHA, tol=1e-4,
                          progress=lambda d, t: seen.append((d, t)), **cut, **small["kw"])
    _assert_results_equal(got, whole)
    it = got.n_iters.numpy()
    assert (it == MAXITER).any() and (it < MAXITER).any()
    assert all(t == R for _, t in seen) and seen[-1] == (R, R)
    done = [d for d, _ in seen]
    assert done == sorted(done)
    for b, d in zip(_boundary_iterations(cut.get("chunk_iters"), cut.get("compact_schedule")),
                    done):
        assert d == int((it <= b).sum())
    if "chunk_iters" in cut:
        assert len(seen) == len(_boundary_iterations(7, None))


def test_fit_restarts_auto_below_8_lanes_is_one_uncut_fit(small, monkeypatch):
    """With R = 4 there is no pilot: one uncut fit, which reports its end
    once."""
    seen, calls = [], []
    fit = tm.fit

    def spy(*a, **k):
        calls.append(k["compact_schedule"])
        return fit(*a, **k)

    monkeypatch.setattr(tm, "fit", spy)
    res, info = tr.fit_restarts_auto(SEED, small["X"], small["cfg"], ALPHA, restarts=4,
                                     maxiter=MAXITER, tol=1e-4, pilot_restarts=2, device="cpu",
                                     progress=lambda d, t: seen.append((d, t)))
    assert calls == [None] and seen == [(4, 4)]
    assert info["schedule"] == () and info["pilot_restarts"] == 4 and "note" in info
    assert res.ll.shape == (4, 2) and torch.isfinite(res.ll).all()


@pytest.mark.parametrize("forced", [None, (20, 9)], ids=["derived", "schedule forced to (20, 9)"])
def test_fit_restarts_auto_equals_fit_restarts_lane_for_lane(small, whole, monkeypatch, forced):
    """The first 3 lanes run uncut as the pilot, the other 5 with the
    derived schedule (here the DP declines to cut 5 lanes; forced, the rest
    runs compacted); concatenated in lane order they are `fit_restarts`'s
    lanes. `progress` reports the pilot first."""
    monkeypatch.setattr(tr, "_SCHEDULE_MEMO", {})
    if forced:
        monkeypatch.setattr(tr, "suggest_compact_schedule", lambda *a, **k: forced)
    seen = []
    got, info = tr.fit_restarts_auto(SEED, small["X"], small["cfg"], ALPHA, tol=1e-4,
                                     pilot_restarts=3,
                                     progress=lambda d, t: seen.append((d, t)), **small["kw"])
    _assert_results_equal(got, whole)
    assert info["pilot_restarts"] == 3 and info["schedule"] == (forced or ())
    assert info["pilot_iters_max"] == int(whole.n_iters[:3].max())
    assert info["lane_iters_per_s"] > 0 and info["boundary_s"] > 0
    assert seen[0] == (3, R) and seen[-1] == (R, R) and len(seen) == (4 if forced else 2)
    assert [d for d, _ in seen] == sorted(d for d, _ in seen)


def test_two_stage_auto_and_chunked_equal_the_uncut_two_stage_fit(small, two_stage, capsys):
    """`fit_mmctm_restarts(compact_schedule="auto")` selects the model of
    the uncut two-stage fit, records the derivation on the model and prints
    it; `two_stage_fit(chunk_iters=9)` cuts both stages and reports each."""
    want_best, want_s1, want_s2, want_idx = two_stage
    model = mt.fit_mmctm_restarts([2, 2], ALPHA, small["docs"], seed=SEED, dtype=torch.float64,
                                  compact_schedule="auto", pilot_restarts=3, verbose=True,
                                  **small["kw"])
    assert "auto-compact: schedule=" in capsys.readouterr().out
    assert model.compact_info["pilot_restarts"] == 3
    np.testing.assert_allclose(model.stage1_ll, want_s1.ll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(model.ll, want_best.ll[0].numpy(), rtol=1e-12)
    assert len(model.ll_history) == int(want_best.n_iters[0])

    seen = []
    best, s1, s2, idx = tr.two_stage_fit(SEED, small["X"], small["cfg"], ALPHA, chunk_iters=9,
                                         progress=lambda *a: seen.append(a), **small["kw"])
    assert idx == want_idx
    _assert_results_equal(s1, want_s1)
    _assert_results_equal(s2, want_s2)
    stage1 = [a for a in seen if a[0] == 1]
    stage2 = [a for a in seen if a[0] == 2]
    assert stage1[-1] == (1, R, R) and stage2[-1] == (2, 1, 1)
    assert len(stage1) > 1 and seen == stage1 + stage2


@pytest.mark.parametrize("cut", [dict(compact_schedule=(22,)), dict(chunk_iters=15),
                                 dict(compact_schedule="auto", pilot_restarts=3)],
                         ids=["schedule=(22,)", "chunk_iters=15", "auto"])
def test_fit_immctm_restarts_cut_selects_the_uncut_lane(small, immctm_whole, cut):
    got = mt.fit_immctm_restarts([2, 2], ALPHA, small["features"], small["docs"], **cut,
                                 **IMMCTM_KW)
    want = immctm_whole
    _assert_results_equal(got.restart_result, want.restart_result)
    np.testing.assert_allclose(got.ll, want.ll, rtol=1e-12)
    assert hasattr(got, "compact_info") == (cut.get("compact_schedule") == "auto")


@pytest.mark.parametrize("compact_schedule, fits", [(None, 1), ("auto", 2)])
def test_fit_immctm_restarts_reaches_the_names_the_harness_patches(small, monkeypatch,
                                                                   compact_schedule, fits):
    """The benchmark's harness wraps `immctm.fit` and
    `restarts.rescore_immctm_f64` as module attributes
    (portbench/instrument.py): the restart fitter looks both up when it
    runs, the fit once per batch (twice with "auto": the pilot and the
    rest), the re-score once."""
    calls = []

    def spy(name, orig):
        def wrapped(*a, **k):
            calls.append(name)
            return orig(*a, **k)
        return wrapped

    monkeypatch.setattr(tr, "_SCHEDULE_MEMO", {})
    monkeypatch.setattr(tr.immctm_mod, "fit", spy("fit", tr.immctm_mod.fit))
    monkeypatch.setattr(tr, "rescore_immctm_f64", spy("rescore", tr.rescore_immctm_f64))
    model = mt.fit_immctm_restarts([2, 2], ALPHA, small["features"], small["docs"],
                                   compact_schedule=compact_schedule, **IMMCTM_KW)
    assert calls == ["fit"] * fits + ["rescore"]
    assert model.restart_result.ll.shape == (R, 2)


@pytest.mark.parametrize("case", [
    dict(iters=np.minimum(40 + np.random.default_rng(0).gamma(2.0, 45.0, 64).astype(np.int64),
                          400), t_warm=0.41, production=936, maxiter=1000, t_boundary=1.3e-3),
    dict(iters=np.random.default_rng(1).integers(30, 180, 50).astype(np.int32), t_warm=0.2,
         production=50, maxiter=1000, t_boundary=4e-4),
    dict(iters=np.full(20, 33), t_warm=0.05, production=80, maxiter=500, t_boundary=1e-3),
    dict(iters=np.random.default_rng(2).integers(20, 400, 64), t_warm=3.0, production=936,
         maxiter=300, t_boundary=0.25),
], ids=["brca-like R=1000", "R=100", "tight", "slow boundary"])
def test_derive_auto_schedule_matches_jax(monkeypatch, case):
    """The same pilot counts, pilot wall and boundary cost give the JAX
    package's schedule and info."""
    for mod in (jr, tr):
        monkeypatch.setattr(mod, "_BOUNDARY_CACHE", {})
        monkeypatch.setattr(mod, "_SCHEDULE_MEMO", {})
        monkeypatch.setattr(mod, "measure_boundary_seconds",
                            lambda *a, **k: case["t_boundary"])
    args = (case["iters"], case["t_warm"], case["production"], case["maxiter"], 3)
    want = jr._derive_auto_schedule(*args)
    got = tr._derive_auto_schedule(*args, (None, None, torch.zeros(1), None))
    assert got == want
    assert all(isinstance(c, int) for c in got[0])


def test_schedule_memo_survives_timing_noise_and_evicts_fifo(monkeypatch):
    monkeypatch.setattr(tr, "_SCHEDULE_MEMO", {})
    monkeypatch.setattr(tr, "measure_boundary_seconds_cached", lambda carry, reps=5: 2e-3)
    iters = np.random.default_rng(7).integers(40, 300, 64).astype(np.int32)
    s1, info1 = tr._derive_auto_schedule(iters, 0.5, 936, 1000, 3, None)
    assert not info1["schedule_memo_hit"] and s1
    # a 40x slower pilot would decline every boundary, but the memo holds
    s2, info2 = tr._derive_auto_schedule(iters, 20.0, 936, 1000, 3, None)
    assert info2["schedule_memo_hit"] and s2 == s1 and info2["pilot_warm_s"] == 20.0
    assert not tr._derive_auto_schedule(iters, 20.0, 100, 1000, 3, None)[1]["schedule_memo_hit"]
    first = next(iter(tr._SCHEDULE_MEMO))
    rng = np.random.default_rng(9)
    for i in range(tr._SCHEDULE_MEMO_MAX + 5):
        tr._derive_auto_schedule(rng.integers(40, 300, 16).astype(np.int32), 0.5, 100 + i, 500,
                                 2, None)
    assert len(tr._SCHEDULE_MEMO) == tr._SCHEDULE_MEMO_MAX and first not in tr._SCHEDULE_MEMO


def test_measure_boundary_seconds_times_a_carry_once_per_device(whole, monkeypatch):
    res = whole
    carry = (res.state, res.ll_history, res.n_iters, res.converged)
    t = tr.measure_boundary_seconds(carry, reps=2)
    assert 0 < t < 60
    monkeypatch.setattr(tr, "_BOUNDARY_CACHE", {})
    calls = []
    monkeypatch.setattr(tr, "measure_boundary_seconds", lambda c, reps=5: calls.append(c) or 0.5)
    assert tr.measure_boundary_seconds_cached(carry) == 0.5
    assert tr.measure_boundary_seconds_cached(carry) == 0.5 and len(calls) == 1
    assert list(tr._BOUNDARY_CACHE) == ["cpu"]


def test_full_budgets_flag_reaches_the_fit(monkeypatch):
    """With the flag set, a float32 fit's η side runs the cold-start
    budgets: `solve_eta` hands the split route no cap."""
    seen = []

    def spy(*a, **k):
        seen.append({name: k[name] for name in ("nu_n_iter", "n_iter", "cg_iter", "polish_iter")})
        return split_eta(*a, **k)

    split_eta = ctm_base.split_eta
    monkeypatch.setattr(ctm_base, "split_eta", spy)
    cfg = tm.MMCTMConfig(K=(1, 1), V=(2, 2), D=3, dtype=torch.float32)
    X = [np.ones((3, 2)), np.ones((3, 2))]
    for flag in (False, True):
        monkeypatch.setattr(flags, "F32_FULL_BUDGETS", flag)
        tr.fit_restarts(0, X, cfg, ALPHA, restarts=2, maxiter=1, device="cpu")
    assert seen == [dict(nu_n_iter=4, n_iter=3, cg_iter=4, polish_iter=1),
                    dict(nu_n_iter=None, n_iter=None, cg_iter=None, polish_iter=None)]


def _call(name, small):
    X, cfg, docs, features = small["X"], small["cfg"], small["docs"], small["features"]
    kw = dict(restarts=2, maxiter=2, device="cpu")
    lda_docs = [mt.make_count_matrix(row) for row in X[0]]
    calls = {
        "fit_restarts: chunk_iters and a schedule": lambda: tr.fit_restarts(
            0, X, cfg, ALPHA, chunk_iters=5, compact_schedule=(3,), **kw),
        "fit_restarts: 'auto'": lambda: tr.fit_restarts(
            0, X, cfg, ALPHA, compact_schedule="auto", **kw),
        "fit_restarts: chunk_iters=0": lambda: tr.fit_restarts(0, X, cfg, ALPHA, chunk_iters=0,
                                                               **kw),
        "two_stage_fit: another string": lambda: tr.two_stage_fit(
            0, X, cfg, ALPHA, compact_schedule="fast", **kw),
        "two_stage_fit: 'auto' and chunk_iters": lambda: tr.two_stage_fit(
            0, X, cfg, ALPHA, compact_schedule="auto", chunk_iters=5, **kw),
        "two_stage_fit: chunk_iters and a schedule": lambda: tr.two_stage_fit(
            0, X, cfg, ALPHA, compact_schedule=(3,), chunk_iters=5, **kw),
        "fit_mmctm_restarts: 'auto' and chunk_iters": lambda: mt.fit_mmctm_restarts(
            [2, 2], ALPHA, docs, compact_schedule="auto", chunk_iters=5, **kw),
        "fit_immctm_restarts: 'auto' and chunk_iters": lambda: mt.fit_immctm_restarts(
            [2, 2], ALPHA, features, docs, compact_schedule="auto", chunk_iters=5, **kw),
        "fit_immctm_restarts: chunk_iters and a schedule": lambda: mt.fit_immctm_restarts(
            [2, 2], ALPHA, features, docs, compact_schedule=(3,), chunk_iters=5, **kw),
        "fit_immctm_restarts: another string": lambda: mt.fit_immctm_restarts(
            [2, 2], ALPHA, features, docs, compact_schedule="fast", **kw),
    }
    for family, fit in (("fit_lda_restarts", lambda **k: mt.fit_lda_restarts(
                            2, 0.1, 0.1, lda_docs, **kw, **k)),
                        ("fit_ilda_restarts", lambda **k: mt.fit_ilda_restarts(
                            2, 0.1, 0.1, features[0], lda_docs, **kw, **k))):
        calls[f"{family}: 'auto' and chunk_iters"] = partial(fit, compact_schedule="auto",
                                                             chunk_iters=5)
        calls[f"{family}: chunk_iters and a schedule"] = partial(fit, compact_schedule=(3,),
                                                                 chunk_iters=5)
        calls[f"{family}: another string"] = partial(fit, compact_schedule="fast")
        calls[f"{family}: chunk_iters=0"] = partial(fit, chunk_iters=0)
    return calls[name]


@pytest.mark.parametrize("name, match", [
    ("fit_restarts: chunk_iters and a schedule", "mutually exclusive"),
    ("fit_restarts: 'auto'", "fit_restarts_auto"),
    ("fit_restarts: chunk_iters=0", "at least 1"),
    ("two_stage_fit: another string", "expected 'auto' or a tuple"),
    ("two_stage_fit: 'auto' and chunk_iters", "mutually exclusive"),
    ("two_stage_fit: chunk_iters and a schedule", "mutually exclusive"),
    ("fit_mmctm_restarts: 'auto' and chunk_iters", "mutually exclusive"),
    ("fit_immctm_restarts: 'auto' and chunk_iters", "mutually exclusive"),
    ("fit_immctm_restarts: chunk_iters and a schedule", "mutually exclusive"),
    ("fit_immctm_restarts: another string", "expected 'auto' or a tuple"),
    ("fit_lda_restarts: 'auto' and chunk_iters", "mutually exclusive"),
    ("fit_lda_restarts: chunk_iters and a schedule", "mutually exclusive"),
    ("fit_lda_restarts: another string", "expected 'auto' or a tuple"),
    ("fit_lda_restarts: chunk_iters=0", "at least 1"),
    ("fit_ilda_restarts: 'auto' and chunk_iters", "mutually exclusive"),
    ("fit_ilda_restarts: chunk_iters and a schedule", "mutually exclusive"),
    ("fit_ilda_restarts: another string", "expected 'auto' or a tuple"),
    ("fit_ilda_restarts: chunk_iters=0", "at least 1"),
])
def test_options_that_exclude_each_other_raise(small, monkeypatch, name, match):
    """Each raises ValueError before any CAVI iteration runs."""
    monkeypatch.setattr(ctm_base, "run_cavi_from", lambda *a, **k: pytest.fail("a fit ran"))
    with pytest.raises(ValueError, match=match):
        _call(name, small)()
