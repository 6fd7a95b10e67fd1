"""The PyTorch special functions against the JAX package's, in float64.

The inputs are those of tests/test_special.py (plus wider ranges). Tolerance:
rtol 1e-12. torch.special and jax.scipy.special use different
digamma/lgamma approximations; over 4000 points in [1e-3, 200] they differ
by at most 1.4e-12 relative, next to digamma's root, so a seeded input that
lands there could need more."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.ops import special as jax_special

from multimodalmusig_tpu_torch.ops import special

torch.set_num_threads(2)

RTOL = 1e-12


def _both(fn_name, *args, **kw):
    got = getattr(special, fn_name)(*(torch.as_tensor(a) for a in args), **kw)
    want = getattr(jax_special, fn_name)(*(jnp.asarray(a) for a in args), **kw)
    return np.asarray(got), np.asarray(want)


def test_logmvbeta_vector(rng):
    vals = rng.uniform(0.1, 5.0, size=7)
    got, want = _both("logmvbeta", vals)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("axis", [0, -1])
def test_logmvbeta_batched(rng, axis):
    vals = rng.uniform(0.1, 50.0, size=(3, 4, 5))
    got, want = _both("logmvbeta", vals, axis=axis)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("alpha, n", [(0.1, 96), (0.1, 48), (2.5, 7), (1e-3, 3)])
def test_logmvbeta_symmetric(alpha, n):
    got = special.logmvbeta_symmetric(torch.tensor(alpha, dtype=torch.float64), n)
    want = jax_special.logmvbeta_symmetric(jnp.float64(alpha), n)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    # equals logmvbeta(fill(alpha, n)) as used at src/MMCTM.jl:276
    full = special.logmvbeta(torch.full((n,), alpha, dtype=torch.float64))
    np.testing.assert_allclose(float(got), float(full), rtol=RTOL)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_dirichlet_expectation(rng, axis):
    p = np.concatenate([rng.uniform(0.5, 3.0, size=(4, 3)), rng.uniform(0.1, 200.0, size=(4, 3))])
    got, want = _both("dirichlet_expectation", p, axis=axis)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_xlogx_zero_convention(rng):
    x = np.concatenate([[0.0, 1.0, 0.5], rng.uniform(0.0, 3.0, 20)])
    got, want = _both("xlogx", x)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[0] == 0.0


def test_safe_xlogy_zero_counts(rng):
    x = np.array([0.0, 2.0, 0.0, 5.0])
    y = np.array([0.0, 0.5, 1.0, 0.25])  # log(0) would be -inf under x = 0
    got, want = _both("safe_xlogy", x, y)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got, [0.0, 2.0 * np.log(0.5), 0.0, 5.0 * np.log(0.25)])
