"""The PyTorch port on a CUDA card: the λ kernel against its plain version,
the dispatch rule, and a short fit on the card against the same fit in
float64 on the CPU.

Every test is marked `cuda` and skips without a card. The file imports
neither JAX nor the shared conftest fixtures, so it runs on a machine with
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.ops import lambda_kernel as lk
from multimodalmusig_tpu_torch.ops.solvers import lambda_grad

torch.set_num_threads(2)

# float32 kernel against the float32 plain version: the JAX suite's bound
# between its Pallas kernel and its jnp solver
ATOL = 5e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the λ kernel is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _problem(seed, R, D, MK, device):
    rng = np.random.default_rng(seed)
    invS = []
    for _ in range(R):
        A = rng.normal(size=(MK, MK))
        invS.append(np.eye(MK) + 0.05 * (A @ A.T) / MK)
    arrays = (np.zeros((R, D, MK)), rng.uniform(0.5, 1.5, (R, D, MK)),
              rng.uniform(1, 10, (R, D, MK)), rng.uniform(0, 5, (R, D, MK)),
              rng.normal(size=(R, MK)), np.stack(invS))
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("R, D, MK, budgets", [
    (100, 560, 14, dict(n_iter=3, cg_iter=4, polish_iter=1)),
    (100, 560, 14, {}),
    (3, 33, 19, {}),
    (2, 7, 32, {}),
    (1, 5, 1, {}),
])
def test_kernel_matches_plain(cuda, R, D, MK, budgets):
    args = _problem(R * D + MK, R, D, MK, cuda)
    before = lk.LAUNCHES
    got = lk.maximize_lambda_restarts(*args, **budgets)
    want = lk.maximize_lambda_restarts_plain(*args, **budgets)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL
    if not budgets:  # the cold defaults converge
        lam0, nu, ndz, st, mu, invS = args
        assert float(lambda_grad(got, nu, ndz, st, mu.unsqueeze(-2), invS).abs().max()) < 1e-2


def test_single_model_entry(cuda):
    lam0, nu, ndz, st, mu, invS = _problem(1, 1, 96, 14, cuda)
    got = lk.maximize_lambda_fused(lam0[0], nu[0], ndz[0], st[0], mu[0], invS[0])
    want = lk.maximize_lambda_restarts_plain(lam0, nu, ndz, st, mu, invS)[0]
    assert float((got - want).abs().max()) <= ATOL


def test_dispatch_sends_float32_to_the_kernel_and_float64_to_the_plain_solver(cuda):
    args = _problem(2, 2, 40, 14, cuda)
    before = lk.LAUNCHES
    got32 = ctm_base.solve_lambda(*args, n_iter=3, cg_iter=4, polish_iter=1)
    assert lk.LAUNCHES == before + 1
    got64 = ctm_base.solve_lambda(*(a.double() for a in args), n_iter=3, cg_iter=4, polish_iter=1)
    assert lk.LAUNCHES == before + 1 and got64.dtype == torch.float64
    assert float((got32.double() - got64).abs().max()) <= ATOL


def test_wrong_dtype_or_mixed_devices_raise(cuda):
    args = _problem(3, 1, 8, 5, cuda)
    with pytest.raises(TypeError, match="float32"):
        lk.maximize_lambda_restarts(*(a.double() for a in args))
    with pytest.raises(ValueError, match="is on"):
        lk.maximize_lambda_restarts(*args[:5], args[5].cpu())


def test_fit_on_the_card_matches_the_cpu_in_float64(cuda):
    """2 lanes x 10 iterations of the BRCA-EU fit: float32 on the card
    (kernel path) against float64 on the CPU (plain path), with the same
    solver budgets on both sides, so only the precision differs."""
    X = [mt.read_counts_tsv(mt.brca_counts_path(f))[0].T
         for f in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")]
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, lambda_n_iter=3,
                                lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4)
        res = mt.fit_restarts(0, X, config, [0.1, 0.1], restarts=2, maxiter=10, tol=0.0,
                              device=device)
        out.append(res.ll_history.cpu().double().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4)


def test_single_model_on_the_card(cuda):
    rng = np.random.default_rng(0)
    docs = [[mt.make_count_matrix(rng.integers(0, 5, 12)) for _ in range(2)] for _ in range(30)]
    model = mt.MMCTM([3, 2], [0.1, 0.1], [12, 12], docs, device="cuda")
    before = lk.LAUNCHES
    history = model.fit(maxiter=15, tol=0.0)
    assert lk.LAUNCHES - before == 15 and len(history) == 15
    assert np.isfinite(model.ll).all() and np.isfinite(model.elbo)
