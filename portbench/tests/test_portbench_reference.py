"""The plain reference against the port, on the CPU in float64 at a tiny
size: one CAVI step from the same states, the lls of every lane, and the
θ moments."""

import pytest
import torch

from portbench import corpus, reference as ref
from portbench.tests.conftest import TINY_CONFIG


@pytest.fixture(scope="module")
def fitted_steps():
    """The inputs and outputs of the first steps of a 3-lane float64 fit of
    the port on the tiny corpus."""
    from multimodalmusig_tpu_torch.models import mmctm

    X = corpus.load(TINY_CONFIG)["X"]
    K = tuple(TINY_CONFIG["K"])
    cfg = mmctm.MMCTMConfig(K=K, V=tuple(TINY_CONFIG["V"]), D=TINY_CONFIG["D"],
                            dtype=torch.float64)
    Xt = mmctm.counts_tensors(X, cfg, "cpu")
    state = mmctm.init_with_alpha(torch.Generator().manual_seed(3), cfg, Xt, [0.1, 0.1],
                                  restarts=3, device="cpu")
    step = mmctm.fit_step_fn(Xt, torch.stack([x.sum(1) for x in Xt], 1), cfg)
    steps = []
    for _ in range(4):
        new, ll = step(state)
        steps.append((state, new, ll))
        state = new
    return X, K, steps


def _inp(s):
    return {"lam": s.lam, "nu": s.nu, "mu": s.mu, "invSigma": s.invSigma, "alpha": s.alpha,
            "Elnphi": list(s.Elnphi)}


@pytest.mark.parametrize("t", range(4))
def test_one_step_matches_the_port(fitted_steps, t):
    X, K, steps = fitted_steps
    before, after, ll = steps[t]
    X64 = [torch.as_tensor(x) for x in X]
    r = ref.cavi_step(_inp(before), X64, K)
    for name in ("zeta", "nu", "lam", "mu", "Sigma"):
        torch.testing.assert_close(r[name], getattr(after, name), rtol=1e-7, atol=1e-9)
    for a, b in zip(r["gamma"], after.gamma):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(r["ll"], ll, rtol=1e-9, atol=0)


def test_lls_of_states_match_the_ports_rescore(fitted_steps):
    from multimodalmusig_tpu_torch.models import mmctm
    from multimodalmusig_tpu_torch.parallel.rescore import rescore_mmctm_f64

    X, K, steps = fitted_steps
    state = steps[-1][1]
    cfg = mmctm.MMCTMConfig(K=K, V=tuple(TINY_CONFIG["V"]), D=TINY_CONFIG["D"],
                            dtype=torch.float64)
    X64 = [torch.as_tensor(x) for x in X]
    ours = ref.lls_of_states(state.lam, list(state.gamma), X64, K, lanes_per_block=2)
    theirs = rescore_mmctm_f64(state.lam, state.gamma, X64, cfg)
    torch.testing.assert_close(ours, theirs.to(ours.dtype), rtol=1e-12, atol=0)


def test_theta_moments_match_the_ports(fitted_steps):
    from multimodalmusig_tpu_torch.models import ctm_base, mmctm

    X, K, steps = fitted_steps
    state = steps[-1][1]
    cfg = mmctm.MMCTMConfig(K=K, V=tuple(TINY_CONFIG["V"]), D=TINY_CONFIG["D"],
                            dtype=torch.float64)
    X64 = [torch.as_tensor(x) for x in X]
    logw = [e.mT for e in state.Elnphi]
    s_ref, sc_ref = ref.theta_moments(state.lam, logw, X64, K)
    s, sc = ctm_base.theta_moments(state.lam, tuple(logw), tuple(X64), cfg)
    torch.testing.assert_close(s_ref, s, rtol=1e-10, atol=1e-12)
    for a, b in zip(sc_ref, sc):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_solvers_reach_the_optimum():
    """ν and λ of the reference are stationary points of their objectives."""
    g = torch.Generator().manual_seed(0)
    R, D, MK = 2, 5, 4
    A = torch.randn(R, MK, MK, generator=g, dtype=torch.float64)
    invS = A @ A.mT + MK * torch.eye(MK, dtype=torch.float64)
    lam0 = torch.randn(R, D, MK, generator=g, dtype=torch.float64)
    ndz = torch.rand(R, D, MK, generator=g, dtype=torch.float64) * 5
    st = torch.rand(R, D, MK, generator=g, dtype=torch.float64) * 50
    mu = torch.randn(R, MK, generator=g, dtype=torch.float64)
    diag = torch.diagonal(invS, dim1=-2, dim2=-1)[:, None, :]
    nu = ref.solve_nu(lam0, ndz, diag)
    d_nu = -0.5 * diag - 0.5 * ndz * torch.exp(lam0 + 0.5 * nu) + 0.5 / nu
    assert float(d_nu.abs().max()) < 1e-9
    lam = ref.solve_lambda(lam0, nu, ndz, st, mu, invS)
    grad = -((lam - mu[:, None, :]) @ invS) + st - ndz * torch.exp(lam + 0.5 * nu)
    assert float(grad.abs().max()) < 1e-8
