"""The fused λ solve of the PyTorch port: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) and its dispatch rules.
The CUDA kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.

Tolerance: float32, atol 5e-5, the JAX suite's own bound between its Pallas
kernel and its jnp solver (tests/test_pallas_kernels.py:41-132)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.ops.pallas.lambda_kernel import (
    maximize_lambda_fused as jax_fused,
    maximize_lambda_fused_restarts as jax_fused_restarts,
)

from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.ops import lambda_kernel as lk
from multimodalmusig_tpu_torch.ops.solvers import lambda_grad

torch.set_num_threads(2)

ATOL = 5e-5


def _problem(rng, R, D, MK):
    """Seeded problems as in tests/test_pallas_kernels.py, per-lane μ and Σ⁻¹."""
    invS = []
    for _ in range(R):
        A = rng.normal(size=(MK, MK))
        invS.append(np.eye(MK) + 0.05 * (A @ A.T) / MK)
    return [x.astype(np.float32) for x in (
        np.zeros((R, D, MK)),
        rng.uniform(0.5, 1.5, (R, D, MK)),
        rng.uniform(1, 10, (R, D, MK)),
        rng.uniform(0, 5, (R, D, MK)),
        rng.normal(size=(R, MK)),
        np.stack(invS),
    )]


def _torch(args, device="cpu"):
    return [torch.as_tensor(a).to(device) for a in args]


@pytest.mark.parametrize("R, D, MK", [(3, 40, 14), (2, 33, 19), (1, 96, 5)])
def test_plain_matches_jax_restart_kernel(rng, R, D, MK):
    """Per-lane Σ, ragged D (not a multiple of any tile) and MK = 19."""
    args = _problem(rng, R, D, MK)
    got = lk.maximize_lambda_restarts_plain(*_torch(args)).numpy()
    want = np.asarray(jax_fused_restarts(*map(jnp.asarray, args), tile_b=128, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_matches_jax_restart_kernel_at_cavi_budgets(rng):
    args = _problem(rng, 2, 40, 14)
    kw = dict(n_iter=3, cg_iter=4, polish_iter=1)
    got = lk.maximize_lambda_restarts_plain(*_torch(args), **kw).numpy()
    want = np.asarray(jax_fused_restarts(*map(jnp.asarray, args), tile_b=128, interpret=True, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_single_model_entry_matches_jax_shared_kernel(rng):
    """maximize_lambda_fused (one shared μ/Σ⁻¹ over a (B, MK) batch) is the
    restart entry at R = 1."""
    lam0, nu, ndz, st, mu, invS = _problem(rng, 1, 96, 14)
    args = (lam0[0], nu[0], ndz[0], st[0], mu[0], invS[0])
    got = lk.maximize_lambda_fused(*_torch(args)).numpy()
    want = np.asarray(jax_fused(*map(jnp.asarray, args), tile_b=128, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_plain_result_is_stationary(rng):
    args = _torch(_problem(rng, 2, 64, 14))
    lam = lk.maximize_lambda_restarts_plain(*args)
    lam0, nu, ndz, st, mu, invS = args
    g = lambda_grad(lam, nu, ndz, st, mu.unsqueeze(-2), invS)
    # float32 solve: gradient small relative to the count scale (~10)
    assert float(g.abs().max()) < 1e-2


def test_mk_over_the_kernel_limit_raises():
    big = torch.zeros((1, 4, lk.KERNEL_MAX_MK + 1))
    with pytest.raises(ValueError, match="exceeds the λ kernel's limit"):
        lk.maximize_lambda_restarts(
            big, big, big, big, torch.zeros(1, big.shape[-1]), torch.eye(big.shape[-1])[None]
        )


def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    args = _torch(_problem(rng, 2, 17, 14))
    before = lk.LAUNCHES
    got = lk.maximize_lambda_restarts(*args, n_iter=3, cg_iter=4, polish_iter=1)
    want = lk.maximize_lambda_restarts_plain(*args, n_iter=3, cg_iter=4, polish_iter=1)
    assert torch.equal(got, want)
    assert lk.LAUNCHES == before


def test_other_devices_raise(rng):
    args = [t.to("meta") for t in _torch(_problem(rng, 1, 4, 5))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk.maximize_lambda_restarts(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_solve_lambda_on_cpu_is_the_plain_solver(rng, monkeypatch, dtype):
    """The dispatch rule: CPU tensors of any dtype go to the plain solver
    (only CUDA float32 goes to the kernel)."""
    args = [t.to(dtype) for t in _torch(_problem(rng, 2, 9, 6))]

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel wrapper")

    monkeypatch.setattr(lk, "maximize_lambda_restarts", no_kernel)
    got = ctm_base.solve_lambda(*args, n_iter=3, cg_iter=4, polish_iter=1)
    want = ctm_base.maximize_lambda(*args, n_iter=3, cg_iter=4, polish_iter=1)
    assert torch.equal(got, want)
