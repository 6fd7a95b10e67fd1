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


@pytest.mark.parametrize("R, D, MK", [(2, 21, 40), (1, 9, 128)])
def test_wrapper_above_one_warp_matches_jax_restart_kernel(rng, R, D, MK):
    """MK > 32: the wrapper took MK ≤ 32 only and raised here. It now takes
    MK ≤ 128, the TPU kernel's limit, and a CPU tensor gets the plain
    version, which matches the JAX kernel."""
    args = _problem(rng, R, D, MK)
    got = lk.maximize_lambda_restarts(*_torch(args)).numpy()
    want = np.asarray(jax_fused_restarts(*map(jnp.asarray, args), tile_b=128, interpret=True))
    np.testing.assert_allclose(got, want, atol=ATOL)


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


# Problem counts either side of the layouts' threshold: the single-model
# entry (R = 1, D = 560), the few-problem crossover at MK ≤ 16 and the
# restart batches.
FEW, EDGE, MANY = 560, lk.FEW_PROBLEMS[16], 100 * 560


@pytest.mark.parametrize("n", [FEW, EDGE, MANY])
def test_launch_geometry_covers_every_mk_once_per_layout(n):
    """Every MK from 1 to 128 gets one launch the kernel takes, at the
    smallest P of its layout that holds it; within each layout, each P
    serves one contiguous run of MK, and the runs tile the layout's reach."""
    runs = {}
    for MK in range(1, lk.KERNEL_MAX_MK + 1):
        geo = lk.launch_geometry(1, n, MK)
        lk._check_geometry(geo, MK)  # raises if the kernel does not take it
        width = 2 * geo.P if geo.layout == "pair" else geo.P
        assert width >= MK
        smaller = {"thread": lk.THREAD_P, "pair": (lk.PAIR_P,), "warp": (16, 32),
                   "block": (64, 128)}[geo.layout]
        assert all((2 * p if geo.layout == "pair" else p) < MK for p in smaller if p < geo.P)
        runs.setdefault(geo, []).append(MK)
    for geo, mks in runs.items():
        assert mks == list(range(mks[0], mks[-1] + 1)), (geo, mks)
    assert sorted(mk for mks in runs.values() for mk in mks) == list(range(1, 129))


@pytest.mark.parametrize("MK, few, many", [
    (16, ("warp", 16, 4), ("thread", 16, 64)),
    (17, ("warp", 32, 8), ("pair", 10, 64)),
    (20, ("warp", 32, 8), ("pair", 10, 64)),
    (21, ("warp", 32, 8), ("thread", 24, 64)),
    (32, ("warp", 32, 8), ("thread", 32, 64)),
    (33, ("block", 64, 4), ("block", 64, 4)),
    (64, ("block", 64, 4), ("block", 64, 4)),
    (65, ("block", 128, 2), ("block", 128, 2)),
])
def test_launch_geometry_at_the_layout_boundaries(MK, few, many):
    assert tuple(lk.launch_geometry(1, FEW, MK)) == few
    assert tuple(lk.launch_geometry(100, 560, MK)) == many


@pytest.mark.parametrize("MK, P, layout", [(14, 16, "thread"), (19, 32, "pair")])
def test_launch_geometry_few_problem_crossover_at_r_1(MK, P, layout):
    """One restart (the single-model entry) takes the warp group up to
    FEW_PROBLEMS documents, then one thread per problem, or a pair at MK
    17–20, at any larger count; the crossover depends on R·D alone."""
    edge = lk.FEW_PROBLEMS[P]
    assert lk.launch_geometry(1, 560, MK).layout == "warp"
    assert lk.launch_geometry(1, edge - 1, MK).layout == "warp"
    assert lk.launch_geometry(1, edge, MK).layout == layout
    assert lk.launch_geometry(1, edge, MK) == lk.launch_geometry(edge // 64, 64, MK)
    assert lk.launch_geometry(1, edge, MK) == lk.launch_geometry(1000, 560, MK)
    assert lk.launch_geometry(8, 560, 14).layout == "warp"
    assert lk.launch_geometry(16, 560, 14).layout == "thread"


@pytest.mark.parametrize("MK", [0, -1, lk.KERNEL_MAX_MK + 1])
def test_launch_geometry_out_of_range_mk_raises(MK):
    with pytest.raises(ValueError, match="outside the λ kernel's"):
        lk.launch_geometry(1, 560, MK)
    with pytest.raises(ValueError, match="outside the λ kernel's"):
        lk._candidate_geometries(MK)


@pytest.mark.parametrize("geo, MK", [
    (("thread", 14, 64), 15), (("thread", 18, 64), 17), (("thread", 14, 65), 14),
    (("pair", 8, 64), 17), (("pair", 10, 20), 19), (("pair", 10, 64), 21), (("warp", 16, 3), 14),
    (("warp", 16, 4), 17), (("block", 64, 2), 40), (("block", 64, 4), 65), (("tile", 16, 4), 14),
])
def test_a_launch_the_kernel_does_not_take_raises(rng, geo, MK):
    args = _torch(_problem(rng, 1, 4, MK))
    with pytest.raises(ValueError, match="has no launch"):
        lk._launch_at(geo, *args)


def test_candidate_geometries_are_valid_and_distinct():
    for MK in range(1, lk.KERNEL_MAX_MK + 1):
        cands = lk._candidate_geometries(MK)
        assert len(set(cands)) == len(cands)
        for geo in cands:
            lk._check_geometry(geo, MK)
        assert lk.launch_geometry(100, 560, MK) in cands
        assert lk.launch_geometry(1, 560, MK) in cands


@pytest.mark.parametrize("R, D", [(0, 5), (3, 0)])
def test_empty_batch_gives_an_empty_result(rng, R, D):
    """No restart or no document: an empty λ of the same shape (on the card
    the wrapper returns it without a launch, tests/test_torch_cuda.py)."""
    args = _torch(_problem(rng, 3, 5, 14))
    args = [t[:R] for t in args] if R == 0 else [t[:, :D] for t in args[:4]] + args[4:]
    got = lk.maximize_lambda_restarts(*args)
    assert got.shape == (R, D, 14)
