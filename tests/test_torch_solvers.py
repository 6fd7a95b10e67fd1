"""The plain PyTorch λ and ν solvers against the JAX package's, on the same
numpy inputs.

float64 agreement is held at atol 1e-10: both sides run the same algorithm
at the full f64 budgets (Newton 7, PCG MK, polish 2), and differ only in
summation order (a batched matmul here, a broadcast-multiply-reduce there).
The float32 ill-conditioning fuzz follows tests/test_solvers.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.ops import solvers as jax_solvers

from multimodalmusig_tpu_torch.ops import solvers

torch.set_num_threads(2)


def _spd(rng, mk, cond):
    q, _ = np.linalg.qr(rng.standard_normal((mk, mk)))
    return (q * np.logspace(0.0, np.log10(cond), mk)) @ q.T


def _problem(rng, B, MK, cond=10.0):
    return dict(
        lam0=rng.standard_normal((B, MK)),
        nu=rng.uniform(0.2, 1.5, (B, MK)),
        ndz=rng.uniform(1.0, 10.0, (B, MK)),
        st=rng.uniform(0.0, 5.0, (B, MK)),
        mu=rng.standard_normal(MK),
        invS=_spd(rng, MK, cond),
    )


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def test_objective_and_gradient_match_jax(rng):
    p = _problem(rng, 1, 5)
    args = (p["lam0"][0], p["nu"][0], p["ndz"][0], p["st"][0], p["mu"], p["invS"])
    for name in ("lambda_objective", "lambda_grad"):
        got = getattr(solvers, name)(*map(_t, args))
        want = getattr(jax_solvers, name)(*map(jnp.asarray, args))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("B, MK", [(64, 14), (9, 5), (20, 19)])
def test_maximize_lambda_shared_sigma_matches_jax(rng, B, MK):
    p = _problem(rng, B, MK)
    args = (p["lam0"], p["nu"], p["ndz"], p["st"], p["mu"], p["invS"])
    got = solvers.maximize_lambda(*map(_t, args))
    want = jax_solvers.maximize_lambda(*map(jnp.asarray, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_maximize_lambda_per_lane_sigma_matches_jax(rng):
    """(R, D, MK) with each lane's own μ (R, MK) and Σ⁻¹ (R, MK, MK) against
    per-lane JAX solves."""
    R, D, MK = 3, 17, 14
    lanes = [_problem(rng, D, MK, cond=10.0 ** (r + 1)) for r in range(R)]
    stack = {k: np.stack([lp[k] for lp in lanes]) for k in lanes[0]}
    got = solvers.maximize_lambda(*(
        _t(stack[k]) for k in ("lam0", "nu", "ndz", "st", "mu", "invS")
    )).numpy()
    for r, lp in enumerate(lanes):
        want = jax_solvers.maximize_lambda(*(
            jnp.asarray(lp[k]) for k in ("lam0", "nu", "ndz", "st", "mu", "invS")
        ))
        np.testing.assert_allclose(got[r], np.asarray(want), atol=1e-10)


def test_maximize_lambda_budget_overrides_match_jax(rng):
    p = _problem(rng, 32, 14)
    args = (p["lam0"], p["nu"], p["ndz"], p["st"], p["mu"], p["invS"])
    kw = dict(n_iter=3, cg_iter=4, polish_iter=1)
    got = solvers.maximize_lambda(*map(_t, args), **kw)
    want = jax_solvers.maximize_lambda(*map(jnp.asarray, args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-10)


def test_empty_modality_block_gives_w_zero_coordinates(rng):
    """A document with no counts in one modality has Ndivζ = sumθ = 0 on that
    block (w = 0 coordinates, solvers.py:408-415 of the JAX package): the
    over-step candidates must stay finite there, and the solve must match."""
    p = _problem(rng, 8, 7)
    p["ndz"][:3, 4:] = 0.0
    p["st"][:3, 4:] = 0.0
    p["lam0"][:3, 4:] = 12.0  # far from μ: large δ on the empty block
    args = (p["lam0"], p["nu"], p["ndz"], p["st"], p["mu"], p["invS"])
    got = solvers.maximize_lambda(*map(_t, args)).numpy()
    want = np.asarray(jax_solvers.maximize_lambda(*map(jnp.asarray, args)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-10)
    g = solvers.lambda_grad(_t(got), _t(p["nu"]), _t(p["ndz"]), _t(p["st"]), _t(p["mu"]), _t(p["invS"]))
    assert float(g.abs().max()) < 1e-8


@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6])
def test_lambda_finite_and_stationary_f32(cond):
    """tests/test_solvers.py::TestIllConditionedRobustness for the port:
    PCG and the polish trust region keep every f32 solve finite and
    stationary up to cond(Σ⁻¹) = 1e6."""
    rng = np.random.default_rng(int(cond))
    B, MK = 257, 14
    f32 = torch.float32
    invS = _t(_spd(rng, MK, cond), f32)
    lam0 = _t(rng.standard_normal((B, MK)) * 3.0, f32)
    nu = _t(rng.uniform(1e-5, 2.0, (B, MK)), f32)
    ndz = _t(rng.uniform(0.0, 10.0, (B, MK)) * rng.integers(0, 2, (B, MK)), f32)
    st = _t(rng.uniform(0.0, 50.0, (B, MK)), f32)
    mu = _t(rng.standard_normal(MK), f32)
    lam = solvers.maximize_lambda(lam0, nu, ndz, st, mu, invS)
    assert torch.isfinite(lam).all()
    g_end = solvers.lambda_grad(lam, nu, ndz, st, mu, invS).abs().max()
    g_start = solvers.lambda_grad(lam0, nu, ndz, st, mu, invS).abs().max()
    assert float(g_end) < 1e-2 * max(float(g_start), 1.0)


@pytest.mark.parametrize("n_iter", [None, 4])
def test_maximize_nu_matches_jax(rng, n_iter):
    B, MK = 40, 14
    nu0 = rng.uniform(1e-3, 3.0, (B, MK))
    lam = rng.uniform(-6.0, 4.0, (B, MK))
    ndz = rng.uniform(0.0, 50.0, (B, MK)) * rng.integers(0, 2, (B, MK))
    diag = rng.uniform(0.1, 100.0, (1, MK))
    kw = {} if n_iter is None else {"n_iter": n_iter}
    got = solvers.maximize_nu(*map(_t, (nu0, lam, ndz, diag)), **kw).numpy()
    want = np.asarray(jax_solvers.maximize_nu(*map(jnp.asarray, (nu0, lam, ndz, diag)), **kw))
    assert (got >= solvers.NU_LOWER_BOUND).all()
    np.testing.assert_allclose(got, want, atol=1e-10, rtol=1e-10)


def test_maximize_nu_broadcasts_per_lane_diagonal(rng):
    """(R, D, MK) ν with a per-lane diag(Σ⁻¹) of shape (R, 1, MK)."""
    R, D, MK = 3, 6, 5
    nu0 = np.ones((R, D, MK))
    lam = rng.standard_normal((R, D, MK))
    ndz = rng.uniform(1.0, 10.0, (R, D, MK))
    diag = rng.uniform(0.5, 5.0, (R, 1, MK))
    got = solvers.maximize_nu(*map(_t, (nu0, lam, ndz, diag))).numpy()
    for r in range(R):
        want = jax_solvers.maximize_nu(*map(jnp.asarray, (nu0[r], lam[r], ndz[r], diag[r])))
        np.testing.assert_allclose(got[r], np.asarray(want), atol=1e-10, rtol=1e-10)


def test_maximize_nu_finite_under_extreme_inputs():
    rng = np.random.default_rng(0)
    B, MK = 127, 14
    f32 = torch.float32
    nu = solvers.maximize_nu(
        _t(rng.uniform(1e-7, 5.0, (B, MK)), f32),
        _t(rng.uniform(-40.0, 40.0, (B, MK)), f32),
        _t(rng.uniform(0.0, 1e4, (B, MK)) * rng.integers(0, 2, (B, MK)), f32),
        _t(rng.uniform(1e-3, 1e3, (1, MK)), f32),
    )
    assert torch.isfinite(nu).all()
    assert (nu >= solvers.NU_LOWER_BOUND).all()

