"""The λ solve's options and the last public helpers of the PyTorch port
against the JAX package's, in float64 on the CPU.

* `lambda_extrap`, the secant warm start: the η kernel's plain version with
  `lam_prev` against JAX `solve_eta(..., lam_prev=...)` (rtol 1e-10, the
  trajectory standard of tests/test_trajectory_oracle.py), its ±4 clip, the
  default start (the incoming λ itself), and MMCTM and IMMCTM fits from a
  JAX init against the JAX fits (ll histories at rtol 1e-10).
* `lambda_solver="chol"`, the direct Cholesky direction: against JAX
  `_chol_solve` (rtol 1e-12) and a dense NumPy solve, with Σ⁻¹ shared and
  per problem; against PCG at the optimum (atol 1e-9, both are exact in
  f64); an MMCTM fit against the JAX chol fit (rtol 1e-10); its routes.
* The helpers (ν objective and gradient, check_convergence, the re-scores'
  `lanes=`/`lane_chunk=`, the NumPy pickers, the reference-shaped step
  functions) against their JAX counterparts at rtol 1e-12. The step
  functions that run the ν and λ solvers (`e_step`, `solve_nu`) hold the
  same rtol: both packages run the same iterations in the same order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import ctm_base as jcb, immctm as jim, mmctm as jm
from multimodalmusig_tpu.ops import convergence as jconv, solvers as jsol
from multimodalmusig_tpu.parallel import rescore as jrs

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base as tcb, immctm as tim, mmctm as tm
from multimodalmusig_tpu_torch.ops import convergence as tconv, estep_kernel as ek
from multimodalmusig_tpu_torch.ops import solvers as tsol
from multimodalmusig_tpu_torch.parallel import rescore as trs

from test_immctm import ALPHA, FEATURES, K as IMMCTM_K, X as IMMCTM_X

torch.set_num_threads(2)

RTOL_FIT = 1e-10
RTOL_HELPER = 1e-12
# Short λ budgets, set in both packages' float64 configs of the extrap fits:
# at the full budgets, and even at the float32 fits' (Newton 3, PCG 4,
# polish 1), every λ solve of these small corpora converges to f64 rounding
# from either start, so the secant start would not change the trajectory.
SHORT_BUDGETS = dict(lambda_n_iter=1, lambda_cg_iter=2, lambda_polish_iter=0, nu_n_iter=4)


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _np(x):
    return np.asarray(x, dtype=np.float64)


def _spd(rng, mk, cond):
    q, _ = np.linalg.qr(rng.standard_normal((mk, mk)))
    return (q * np.logspace(0.0, np.log10(cond), mk)) @ q.T


def _fit_jax(state, X, config, maxiter):
    return jax.jit(jm.fit, static_argnames=("config", "maxiter", "tol"))(
        state, X, config, maxiter=maxiter, tol=0.0)


# ---------------------------------------------------------------------------
# Fixtures: a small MMCTM corpus and the JAX package's fits of it
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """Two modalities, K = (3, 2), 6 documents (one with an empty
    modality), the JAX init and the two JAX configs with an option set."""
    rng = np.random.default_rng(11)
    Xnp = [rng.integers(0, 9, (6, 7)).astype(np.float64),
           rng.integers(0, 9, (6, 5)).astype(np.float64)]
    Xnp[1][0] = 0.0
    K, V, D = (3, 2), (7, 5), 6
    jcfg = jm.MMCTMConfig(K=K, V=V, D=D, dtype=jnp.float64)
    tcfg = tm.MMCTMConfig(K=K, V=V, D=D, dtype=torch.float64)
    Xj = tuple(jnp.asarray(x) for x in Xnp)
    init = jm.init_with_alpha(jax.random.key(5), jcfg, Xj, [0.1, 0.2])
    return dict(Xnp=Xnp, Xj=Xj, Xt=tm.counts_tensors(Xnp, tcfg, "cpu"), init=init, jcfg=jcfg,
                tcfg=tcfg, Nj=jcb.counts_per_doc(Xj), Nt=tcb.counts_per_doc(
                    tm.counts_tensors(Xnp, tcfg, "cpu")))


@pytest.fixture(scope="module")
def extrap_fit(corpus):
    """The JAX fit with lambda_extrap = 1.0 at short budgets, 20
    iterations at tol 0."""
    cfg = dataclasses.replace(corpus["jcfg"], lambda_extrap=1.0, **SHORT_BUDGETS)
    return _fit_jax(corpus["init"], corpus["Xj"], cfg, 20)


def _port_fit(corpus, maxiter, **options):
    cfg = dataclasses.replace(corpus["tcfg"], **options)
    return tm.fit(mt.state_from_numpy(corpus["init"], device="cpu"), corpus["Xt"], cfg,
                  maxiter=maxiter, tol=0.0)


def _assert_same_trajectory(got, want, rtol):
    assert int(got.n_iters[0]) == int(want.n_iters)
    np.testing.assert_allclose(got.ll_history[0].numpy(), _np(want.ll_history), rtol=rtol)
    np.testing.assert_allclose(got.state.lam[0].numpy(), _np(want.state.lam), rtol=1e-8,
                               atol=1e-10)


# ---------------------------------------------------------------------------
# lambda_extrap
# ---------------------------------------------------------------------------


def _eta_inputs(rng, D, K, swing):
    MK = sum(K)
    return dict(
        lam=rng.standard_normal((D, MK)), nu=rng.uniform(0.2, 1.5, (D, MK)),
        N=rng.integers(0, 30, (D, len(K))).astype(np.float64),
        st=rng.uniform(0.0, 5.0, (D, MK)), mu=rng.standard_normal(MK),
        invS=_spd(rng, MK, 50.0), lam_prev=rng.standard_normal((D, MK)) * swing,
    )


@pytest.mark.parametrize("swing", [0.3, 6.0])  # the clip idle, and binding on most entries
def test_plain_eta_kernel_with_lam_prev_matches_jax_solve_eta(swing):
    """The η kernel's plain version with `lam_prev` and extrap = 1 against
    JAX solve_eta with lambda_extrap = 1 on two lanes, and the port's
    solve_eta (the split route here) against both."""
    rng = np.random.default_rng(3)
    K = (3, 2)
    lanes = [_eta_inputs(rng, 9, K, swing) for _ in range(2)]
    lanes[1]["N"] = lanes[0]["N"]  # the lanes share the counts
    jcfg = jcb.CTMBaseConfig(K=K, V=(4, 4), D=9, dtype=jnp.float64, lambda_extrap=1.0)
    tcfg = tcb.CTMBaseConfig(K=K, V=(4, 4), D=9, dtype=torch.float64, lambda_extrap=1.0)
    stack = {k: _t(np.stack([p[k] for p in lanes])) for k in lanes[0]}
    args = (stack["lam"], stack["nu"], stack["N"][0], stack["st"], stack["mu"], stack["invS"])
    want = [jcb.solve_eta(*(jnp.asarray(p[k]) for k in ("lam", "nu", "N", "st", "mu", "invS")),
                          jcfg, lam_prev=jnp.asarray(p["lam_prev"])) for p in lanes]
    plain = ek.estep_eta_fused_plain(*args, K, lam_prev=stack["lam_prev"], extrap=1.0)
    split = tcb.solve_eta(*args, tcfg, lam_prev=stack["lam_prev"])
    for r, w in enumerate(want):
        for name, a, b, c in zip(("zeta", "nu", "lam"), plain, split, w):
            np.testing.assert_allclose(a[r].numpy(), _np(c), rtol=RTOL_FIT, atol=1e-12,
                                       err_msg=name)
            np.testing.assert_allclose(b[r].numpy(), _np(c), rtol=RTOL_FIT, atol=1e-12,
                                       err_msg=name)
    # extrapolation changed the solve's start, so the default differs
    default = ek.estep_eta_fused_plain(*args, K)
    assert not torch.equal(default[2], plain[2])
    assert all(torch.equal(a, b) for a, b in zip(default[:2], plain[:2]))  # ζ, ν read λ


def test_extrap_clip_bounds_the_step(monkeypatch):
    """JAX test_extrap_clip_bounds_the_step: a swing of ±100 moves the start
    by ±4 at most, per coordinate; a NaN stays NaN (torch.clamp)."""
    lam = torch.zeros(2, 4, 4, dtype=torch.float64)
    for prev, want in ((-100.0, 4.0), (100.0, -4.0), (-1.5, 1.5)):
        got = tsol.extrapolated_start(lam, torch.full_like(lam, prev), 1.0)
        assert torch.equal(got, torch.full_like(lam, want))
    assert torch.isnan(tsol.extrapolated_start(lam, torch.full_like(lam, torch.nan), 1.0)).all()
    assert tsol.extrapolated_start(lam, torch.full_like(lam, -100.0), 0.0) is lam
    assert tsol.extrapolated_start(lam, None, 1.0) is lam

    captured = {}
    real = tcb.solve_lambda

    def spy(lam0, *a, **k):
        captured["lam0"] = lam0
        return real(lam0, *a, **k)

    monkeypatch.setattr(tcb, "solve_lambda", spy)
    cfg = tcb.CTMBaseConfig(K=(2, 2), V=(3, 3), D=4, dtype=torch.float64, lambda_extrap=1.0)
    tcb.solve_eta(lam, torch.ones_like(lam), torch.full((4, 2), 10.0, dtype=torch.float64),
                  torch.ones_like(lam), torch.zeros(2, 4, dtype=torch.float64),
                  torch.eye(4, dtype=torch.float64).expand(2, 4, 4), cfg,
                  lam_prev=torch.full_like(lam, -100.0))
    assert torch.equal(captured["lam0"], torch.full_like(lam, 4.0))


def _spy_starts(monkeypatch):
    """Record (λ given to solve_eta, lam_prev, λ₀ given to solve_lambda,
    whether λ₀ is that λ) for every η side of a fit (JAX test_solvers.py
    _spy_lam0), as their values at the call: the fit loop writes its carry,
    which holds λ and lam_prev, in place after each step."""
    calls, current = [], {}
    real_eta, real_lambda = tcb.solve_eta, tcb.solve_lambda

    def spy_eta(lam, *a, **k):
        current.update(lam=lam, lam_prev=k.get("lam_prev"))
        return real_eta(lam, *a, **k)

    def spy_lambda(lam0, *a, **k):
        lam, prev = current["lam"], current["lam_prev"]
        calls.append((lam.clone(), None if prev is None else prev.clone(), lam0.clone(),
                      lam0 is lam))
        return real_lambda(lam0, *a, **k)

    monkeypatch.setattr(tcb, "solve_lambda", spy_lambda)
    monkeypatch.setattr(tm, "solve_eta", spy_eta)
    return calls


def test_default_start_is_the_incoming_lambda(monkeypatch, corpus):
    calls = _spy_starts(monkeypatch)
    _port_fit(corpus, 3)
    assert len(calls) == 3
    assert all(same and prev is not None for _, prev, _, same in calls)


def test_extrap_start_is_the_secant_step(monkeypatch, corpus):
    calls = _spy_starts(monkeypatch)
    _port_fit(corpus, 4, lambda_extrap=0.5)
    assert len(calls) == 4
    for lam, prev, lam0, same in calls:
        assert not same
        assert torch.equal(lam0, lam + torch.clamp(0.5 * (lam - prev), -4.0, 4.0))


def test_fused_route_gets_the_secant_start(monkeypatch):
    """With the route forced to "fused" (the CPU wrapper then runs the plain
    version), solve_eta hands the wrapper lam_prev and the coefficient, and
    gets the split route's bits; without the option it hands it neither."""
    calls = []
    real = ek.estep_eta_fused

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    rng = np.random.default_rng(4)
    p = _eta_inputs(rng, 6, (3, 2), 2.0)
    args = (_t(p["lam"])[None], _t(p["nu"])[None], _t(p["N"]), _t(p["st"])[None],
            _t(p["mu"])[None], _t(p["invS"])[None])
    prev = _t(p["lam_prev"])[None]
    cfg = tcb.CTMBaseConfig(K=(3, 2), V=(4, 4), D=6, dtype=torch.float64, lambda_extrap=1.0)
    split = tcb.solve_eta(*args, cfg, lam_prev=prev)
    monkeypatch.setattr(ek, "estep_eta_fused", spy)
    monkeypatch.setattr(tcb, "_eta_route", lambda *a: "fused")
    fused = tcb.solve_eta(*args, cfg, lam_prev=prev)
    assert calls[-1]["lam_prev"] is prev and calls[-1]["extrap"] == 1.0
    assert all(torch.equal(a, b) for a, b in zip(fused, split))
    tcb.solve_eta(*args, dataclasses.replace(cfg, lambda_extrap=None), lam_prev=prev)
    assert "lam_prev" not in calls[-1] and "extrap" not in calls[-1]


def test_mmctm_extrap_fit_matches_jax(corpus, extrap_fit):
    got = _port_fit(corpus, 20, lambda_extrap=1.0, **SHORT_BUDGETS)
    _assert_same_trajectory(got, extrap_fit, RTOL_FIT)
    default = _port_fit(corpus, 20, **SHORT_BUDGETS)
    assert not np.allclose(default.ll_history.numpy(), got.ll_history.numpy(), rtol=1e-8, atol=0)


def test_immctm_extrap_fit_matches_jax(immctm_extrap):
    f = immctm_extrap
    got = tim.fit(mt.immctm_state_from_numpy(f["model"].state, device="cpu"), f["Xt"], f["Ft"],
                  f["tcfg"], maxiter=20, tol=0.0)
    _assert_same_trajectory(got, f["fit"], RTOL_FIT)
    default = tim.fit(mt.immctm_state_from_numpy(f["model"].state, device="cpu"), f["Xt"],
                      f["Ft"], dataclasses.replace(f["tcfg"], lambda_extrap=None), maxiter=20,
                      tol=0.0)
    assert not np.allclose(default.ll_history.numpy(), got.ll_history.numpy(), rtol=1e-8, atol=0)


@pytest.fixture(scope="module")
def immctm_extrap():
    """The reference IMMCTM fixture, its JAX fit with lambda_extrap = 1.0 at
    short budgets (20 iterations at tol 0) and the port's config and
    tensors."""
    model = jim.IMMCTM(IMMCTM_K, ALPHA, FEATURES, IMMCTM_X)
    jcfg = dataclasses.replace(model.config, lambda_extrap=1.0, **SHORT_BUDGETS)
    fit = jax.jit(jim.fit, static_argnames=("config", "maxiter", "tol"))(
        model.state, model.Xdense, model.F, jcfg, maxiter=20, tol=0.0)
    tcfg = tim.IMMCTMConfig(K=jcfg.K, V=jcfg.V, D=jcfg.D, dtype=torch.float64, J=jcfg.J,
                            lambda_extrap=1.0, **SHORT_BUDGETS)
    Xt = tuple(_t(x) for x in model.Xdense)
    Ft = tuple(tuple(_t(f) for f in fm) for fm in model.F)
    return dict(model=model, jcfg=jcfg, tcfg=tcfg, fit=fit, Xt=Xt, Ft=Ft)


# ---------------------------------------------------------------------------
# lambda_solver = "chol"
# ---------------------------------------------------------------------------


def test_chol_direction_matches_jax_and_a_dense_solve_with_a_shared_sigma():
    rng = np.random.default_rng(7)
    B, MK = 31, 14
    invS = _spd(rng, MK, 1e4)
    w, g = rng.gamma(1.0, 2.0, (B, MK)), rng.standard_normal((B, MK))
    got = tsol._chol_solve(_t(w), _t(g), _t(invS)).numpy()
    want = _np(jsol._chol_solve(jnp.asarray(w), jnp.asarray(g), jnp.asarray(invS)))
    np.testing.assert_allclose(got, want, rtol=RTOL_HELPER, atol=1e-14)
    dense = np.stack([np.linalg.solve(invS + np.diag(w[b]), g[b]) for b in range(B)])
    np.testing.assert_allclose(got, dense, rtol=1e-9, atol=1e-11)


def test_chol_direction_matches_jax_and_a_dense_solve_with_a_sigma_per_problem():
    """JAX's batched Σ⁻¹ (B, MK, MK) against (B, MK) problems is the port's
    restart form: (R, MK, MK) against (R, D, MK) with D = 1; and R lanes of
    D documents against a dense solve."""
    rng = np.random.default_rng(8)
    B, MK = 5, 6
    invS = np.stack([_spd(rng, MK, 1e2) for _ in range(B)])
    w, g = rng.gamma(1.0, 2.0, (B, MK)), rng.standard_normal((B, MK))
    got = tsol._chol_solve(_t(w)[:, None], _t(g)[:, None], _t(invS))[:, 0].numpy()
    want = _np(jsol._chol_solve(jnp.asarray(w), jnp.asarray(g), jnp.asarray(invS)))
    np.testing.assert_allclose(got, want, rtol=RTOL_HELPER, atol=1e-14)
    w, g = rng.gamma(1.0, 2.0, (B, 4, MK)), rng.standard_normal((B, 4, MK))
    got = tsol._chol_solve(_t(w), _t(g), _t(invS)).numpy()
    dense = np.stack([[np.linalg.solve(invS[r] + np.diag(w[r, d]), g[r, d]) for d in range(4)]
                      for r in range(B)])
    np.testing.assert_allclose(got, dense, rtol=1e-9, atol=1e-11)


def test_chol_and_pcg_reach_the_same_optimum():
    rng = np.random.default_rng(9)
    B, MK = 64, 14
    args = (rng.standard_normal((B, MK)), rng.uniform(1e-5, 2.0, (B, MK)),
            rng.uniform(0.0, 10.0, (B, MK)), rng.uniform(0.0, 50.0, (B, MK)),
            rng.standard_normal(MK), _spd(rng, MK, 1e3))
    a = tsol.maximize_lambda(*map(_t, args))
    b = tsol.maximize_lambda(*map(_t, args), solver="chol")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)
    want = jsol.maximize_lambda(*map(jnp.asarray, args), solver="chol")
    np.testing.assert_allclose(b.numpy(), _np(want), atol=1e-10)


def test_mmctm_chol_fit_matches_jax(corpus):
    cfg = dataclasses.replace(corpus["jcfg"], lambda_solver="chol")
    want = _fit_jax(corpus["init"], corpus["Xj"], cfg, 15)
    got = _port_fit(corpus, 15, lambda_solver="chol")
    _assert_same_trajectory(got, want, RTOL_FIT)


def test_an_invalid_solver_raises(corpus):
    z = torch.zeros(2, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="solver"):
        tsol.maximize_lambda(z, z, z, z, torch.zeros(3, dtype=torch.float64),
                             torch.eye(3, dtype=torch.float64), solver="qr")
    with pytest.raises(ValueError, match="solver"):
        _port_fit(corpus, 2, lambda_solver="qr")


@pytest.mark.parametrize("solver, eta, lam", [
    (None, "fused", "kernel"), ("pcg", "fused", "kernel"), ("chol", "split", "plain"),
])
def test_routes_follow_the_solver(solver, eta, lam):
    """"chol" takes the split η route and the plain λ solver even for CUDA
    float32, where the kernels would run; on the CPU every solver is plain."""
    assert tcb._eta_route("cuda", torch.float32, 14, solver) == eta
    assert tcb._lambda_route("cuda", torch.float32, 14, solver) == lam
    assert tcb._eta_route("cpu", torch.float32, 14, solver) == "split"
    assert tcb._lambda_route("cpu", torch.float32, 14, solver) == "plain"


# ---------------------------------------------------------------------------
# The helpers: ν objective, convergence, re-scores, pickers
# ---------------------------------------------------------------------------


def test_nu_objective_terms_and_gradient_match_jax():
    rng = np.random.default_rng(12)
    args = (rng.uniform(0.1, 2.0, 9), rng.standard_normal(9), rng.uniform(0.0, 5.0, 9),
            rng.uniform(0.5, 3.0, 9))
    for name in ("nu_objective", "nu_objective_terms", "nu_grad"):
        got = getattr(tsol, name)(*map(_t, args))
        want = getattr(jsol, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL_HELPER, err_msg=name)
    batched = tsol.nu_objective(*(_t(np.stack([a, a])) for a in args))
    np.testing.assert_allclose(batched.numpy(), float(jsol.nu_objective(
        *map(jnp.asarray, args))), rtol=RTOL_HELPER)


@pytest.mark.parametrize("prev, curr, tol", [
    (-3.1, -3.1000001, 1e-4), (-3.1, -3.2, 1e-4), ([-3.9, -3.0], [-3.9000001, -3.0], 1e-5),
    ([-3.9, -3.0], [-3.9, -3.1], 1e-5), ([1.0, 2.0], [1.0, 2.0], 0.0),
])
def test_check_convergence_matches_jax(prev, curr, tol):
    got = tconv.check_convergence(_t(prev), _t(curr), tol)
    want = jconv.check_convergence(jnp.asarray(prev), jnp.asarray(curr), tol)
    assert got.shape == () and bool(got) == bool(want)
    lanes = tconv.check_convergence(*(_t(np.tile(np.reshape(x, (1, -1)), (2, 1)))
                                      for x in (prev, curr)), tol)  # (R, M) lanes
    assert lanes.tolist() == [bool(want)] * 2


def _immctm_lanes(rng, R, D, K, V, J):
    """Random (λ, γ, X, F) of an IMMCTM batch, F one-hot (V_m, J_mi)."""
    lam = rng.standard_normal((R, D, sum(K)))
    gamma = tuple(tuple(rng.uniform(0.1, 5.0, (R, k, j)) for j in Jm) for k, Jm in zip(K, J))
    X = tuple(rng.integers(0, 6, (D, v)).astype(np.float64) for v in V)
    F = tuple(tuple(np.eye(j)[rng.integers(0, j, v)] for j in Jm) for v, Jm in zip(V, J))
    return lam, gamma, X, F


@pytest.mark.parametrize("lanes, lane_chunk", [(None, 2), ([4, 0, 3], 2), ([1, 2], 64)])
def test_rescores_take_lanes_and_lane_chunk_as_jax(lanes, lane_chunk):
    rng = np.random.default_rng(13)
    R, D = 5, 7
    K, V, J = (2, 3), (6, 4), ((2, 3), (2, 2))
    jcfg = jcb.CTMBaseConfig(K=K, V=V, D=D, dtype=jnp.float64)
    tcfg = tcb.CTMBaseConfig(K=K, V=V, D=D, dtype=torch.float64)
    lam, gamma, X, F = _immctm_lanes(rng, R, D, K, V, J)
    kw_j = dict(lanes=None if lanes is None else np.asarray(lanes), lane_chunk=lane_chunk)

    got = trs.rescore_immctm_f64(_t(lam), tuple(tuple(map(_t, g)) for g in gamma),
                                 X, tuple(tuple(map(_t, f)) for f in F), tcfg, **kw_j)
    want = jrs.rescore_immctm_f64(lam, gamma, X, F, jcfg, **kw_j)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_HELPER)

    mm_gamma = tuple(rng.uniform(0.1, 5.0, (R, k, v)) for k, v in zip(K, V))
    got = trs.rescore_mmctm_f64(_t(lam), tuple(map(_t, mm_gamma)), X, tcfg, **kw_j)
    want = jrs.rescore_mmctm_f64(lam, mm_gamma, X, jcfg, **kw_j)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_HELPER)

    g_lda, l_lda = rng.uniform(0.1, 5.0, (R, D, 3)), rng.uniform(0.1, 5.0, (R, V[0], 3))
    got = trs.rescore_lda_f64(_t(g_lda), _t(l_lda), X[0], **kw_j)
    want = jrs.rescore_lda_f64(g_lda, l_lda, X[0], **kw_j)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_HELPER)

    l_ilda = tuple(rng.uniform(0.1, 5.0, (R, j, 3)) for j in J[0])
    got = trs.rescore_ilda_f64(_t(g_lda), tuple(map(_t, l_ilda)), X[0], tuple(map(_t, F[0])),
                               **kw_j)
    want = jrs.rescore_ilda_f64(g_lda, l_ilda, X[0], F[0], **kw_j)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_HELPER)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_pickers_match_jax(seed):
    rng = np.random.default_rng(seed)
    ll = np.round(rng.uniform(-4.0, -3.0, (9, 2)), 2)  # rounded: ties in the ranks
    ll[rng.integers(0, 9)] = np.nan
    assert np.array_equal(trs.dense_rank_np(ll[:, 0]), jrs.dense_rank_np(ll[:, 0]))
    assert np.array_equal(trs.pick_optimal_modality_restarts_np(ll),
                          jrs.pick_optimal_modality_restarts_np(ll))
    assert trs.pick_optimal_restart_np(ll) == jrs.pick_optimal_restart_np(ll)
    assert trs.pick_optimal_restart_np(ll[:, 1]) == jrs.pick_optimal_restart_np(ll[:, 1])


# ---------------------------------------------------------------------------
# The reference-shaped step functions, from the JAX extrap fit's last state
# (λ and λ_pre differ there, so `e_step` exercises the secant start)
# ---------------------------------------------------------------------------


def _lane0_close(got, want, rtol=RTOL_HELPER, atol=0.0, name=""):
    np.testing.assert_allclose(got[0].numpy(), _np(want), rtol=rtol, atol=atol, err_msg=name)


def _assert_state_close(got, want, fields, atol=1e-13):
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        for a, b in zip(g if isinstance(g, tuple) else (g,), w if isinstance(w, tuple) else (w,)):
            _lane0_close(a, b, atol=atol, name=name)


def test_mmctm_theta_steps_match_jax(corpus, extrap_fit):
    js = extrap_fit.state
    ts = mt.state_from_numpy(js, device="cpu")
    cfg_j, cfg_t = corpus["jcfg"], corpus["tcfg"]
    for got, want in zip(tm.update_theta(ts, cfg_t), jm.update_theta(js, cfg_j)):
        _lane0_close(got, want)
    phi_j = jm.phi_point(js.gamma)
    phi_t = tm.phi_point(ts.gamma)
    for got, want in zip(tm.unsmoothed_update_theta(ts, phi_t, cfg_t),
                         jm.unsmoothed_update_theta(js, phi_j, cfg_j)):
        _lane0_close(got, want)
    theta_j = jm.update_theta(js, cfg_j)
    theta_t = tm.update_theta(ts, cfg_t)
    _lane0_close(tm.calculate_sumtheta(theta_t, corpus["Xt"], cfg_t),
                 jm.calculate_sumtheta(theta_j, corpus["Xj"], cfg_j))
    _lane0_close(tcb.calculate_sumtheta(theta_t, corpus["Xt"], cfg_t),
                 jcb.calculate_sumtheta(theta_j, corpus["Xj"], cfg_j))


@pytest.mark.parametrize("extrap", [None, 1.0])
def test_mmctm_e_step_matches_jax(corpus, extrap_fit, extrap):
    js = extrap_fit.state
    cfg_j = dataclasses.replace(corpus["jcfg"], lambda_extrap=extrap)
    cfg_t = dataclasses.replace(corpus["tcfg"], lambda_extrap=extrap)
    want_state, want_theta = jm.e_step(js, corpus["Xj"], corpus["Nj"], cfg_j)
    got_state, got_theta = tm.e_step(mt.state_from_numpy(js, device="cpu"), corpus["Xt"],
                                     corpus["Nt"], cfg_t)
    _assert_state_close(got_state, want_state, ("zeta", "nu", "lam", "lam_pre", "logw_pre"))
    for got, want in zip(got_theta, want_theta):
        _lane0_close(got, want)
    # e_step_moments gives the same state without θ
    moments, _ = tm.e_step_moments(mt.state_from_numpy(js, device="cpu"), corpus["Xt"],
                                   corpus["Nt"], cfg_t)
    for name in ("zeta", "nu", "lam"):
        torch.testing.assert_close(getattr(moments, name), getattr(got_state, name),
                                   rtol=RTOL_HELPER, atol=1e-13)


def test_ctm_base_solve_nu_and_elbo_terms_match_jax(corpus, extrap_fit):
    js = extrap_fit.state
    ts = mt.state_from_numpy(js, device="cpu")
    cfg_j, cfg_t = corpus["jcfg"], corpus["tcfg"]
    ndz_j = jcb.calculate_Ndivzeta(corpus["Nj"], js.zeta, cfg_j)
    ndz_t = tcb.calculate_Ndivzeta(corpus["Nt"], ts.zeta, cfg_t)
    for n_iter in (None, 3):
        _lane0_close(tcb.solve_nu(ts.nu, ts.lam, ndz_t, ts.invSigma, n_iter=n_iter),
                     jcb.solve_nu(js.nu, js.lam, ndz_j, js.invSigma, n_iter=n_iter))
    theta_j = jm.update_theta(js, cfg_j)
    theta_t = tm.update_theta(ts, cfg_t)
    got = tcb.elbo_eta_z_terms(ts.lam, ts.nu, ts.zeta, ts.mu, ts.invSigma, theta_t, corpus["Xt"],
                               corpus["Nt"], cfg_t)
    want = jcb.elbo_eta_z_terms(js.lam, js.nu, js.zeta, js.mu, js.invSigma, theta_j,
                                corpus["Xj"], corpus["Nj"], cfg_j)
    assert got.shape == (1,)
    np.testing.assert_allclose(float(got[0]), float(want), rtol=RTOL_HELPER)


def test_immctm_theta_and_e_step_match_jax(immctm_extrap):
    f = immctm_extrap
    js = f["fit"].state
    ts = mt.immctm_state_from_numpy(js, device="cpu")
    m = f["model"]
    for got, want in zip(tim.update_theta(ts, f["Ft"], f["tcfg"]),
                         jim.update_theta(js, m.F, f["jcfg"])):
        _lane0_close(got, want)
    want_state, want_theta = jim.e_step(js, m.Xdense, jim.counts_per_doc(m.Xdense), m.F,
                                        f["jcfg"])
    got_state, got_theta = tim.e_step(ts, f["Xt"], tcb.counts_per_doc(f["Xt"]), f["Ft"],
                                      f["tcfg"])
    _assert_state_close(got_state, want_state, ("zeta", "nu", "lam", "lam_pre", "logw_pre"))
    for got, want in zip(got_theta, want_theta):
        _lane0_close(got, want)
