"""The PyTorch port on a CUDA card: the η, λ and θ kernels against their
plain versions (at the fits' shapes and at the inference and K-selection
shapes), the dispatch rules, and short MMCTM and IMMCTM fits, the compacted
restart fit, the two-stage fit and the inference loops on the card against
the same runs in float64 on the CPU; LDA and ILDA steps through the θ kernel
against the factorized schedule, their launches per iteration, and their
restart fits; the restart fan-out and the data-parallel fit over ranks on
the card, with each rank's launches; the η kernel with the secant start
of `lambda_extrap` against its plain version, its bits without one against
the kernel before it took one, and the routes of the λ solve's options.

Every test is marked `cuda` and skips without a card. The file imports
neither JAX nor the shared conftest fixtures, so it runs on a machine with
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -p no:cacheprovider
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.ops import estep_kernel as ek
from multimodalmusig_tpu_torch.ops import lambda_kernel as lk
from multimodalmusig_tpu_torch.ops import theta_kernel as tk
from multimodalmusig_tpu_torch.ops.solvers import lambda_grad

torch.set_num_threads(2)

# float32 kernel against the float32 plain version: the JAX suite's bound
# between its Pallas kernel and its jnp solver
ATOL = 5e-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
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
    (100, 560, 40, dict(n_iter=3, cg_iter=4, polish_iter=1)),
    (3, 37, 40, {}),
    (2, 19, 64, {}),
    (3, 29, 128, {}),
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


@pytest.mark.parametrize("R, D", [(0, 5), (3, 0)])
def test_empty_batch_returns_empty_without_a_launch(cuda, R, D):
    args = _problem(1, 3, 5, 14, cuda)
    args = [t[:R] for t in args] if R == 0 else [t[:, :D] for t in args[:4]] + args[4:]
    before = lk.LAUNCHES
    got = lk.maximize_lambda_restarts(*args)
    assert got.shape == (R, D, 14) and got.device.type == "cuda"
    assert lk.LAUNCHES == before


def test_single_model_entry(cuda):
    lam0, nu, ndz, st, mu, invS = _problem(1, 1, 96, 14, cuda)
    got = lk.maximize_lambda_fused(lam0[0], nu[0], ndz[0], st[0], mu[0], invS[0])
    want = lk.maximize_lambda_restarts_plain(lam0, nu, ndz, st, mu, invS)[0]
    assert float((got - want).abs().max()) <= ATOL


@pytest.mark.parametrize("R, D, MK", [
    (100, 560, 14),  # the thread layout at BRCA's MK
    (30, 560, 16), (30, 560, 17),  # the thread layout's last MK, the pair's first
    (100, 560, 19),  # PCAWG's MK, on the pair
    (100, 560, 20), (100, 560, 21),  # the pair's last MK on restart batches, the thread's first
    (100, 560, 32), (3, 50, 33),  # the thread layout's last MK, the block's first
    (1, 560, 14), (2, 560, 14), (8, 560, 14),  # the warp group of the single-model entry
    (1, 560, 19), (1, 6143, 14), (1, 6144, 14),  # either side of the few-problem crossover
    (16, 560, 14),  # the thread layout just above the crossover
])
def test_kernel_matches_plain_at_the_layout_boundaries(cuda, R, D, MK):
    """At the f32 CAVI budgets: 5e-5 against the plain version and a
    stationary result after the cold defaults, at either side of each
    boundary of launch_geometry."""
    args = _problem(R * D + 3 * MK, R, D, MK, cuda)
    lam0, nu, ndz, st, mu, invS = args
    for budgets in (dict(n_iter=3, cg_iter=4, polish_iter=1), {}):
        got = lk.maximize_lambda_restarts(*args, **budgets)
        want = lk.maximize_lambda_restarts_plain(*args, **budgets)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= ATOL
    assert float(lambda_grad(got, nu, ndz, st, mu.unsqueeze(-2), invS).abs().max()) < 1e-2


@pytest.mark.parametrize("MK", [6, 14, 19, 32, 40, 128])
def test_every_layout_matches_plain_and_repeats_bit_identically(cuda, MK):
    """Each launch of _candidate_geometries, on ragged D: 5e-5 against the
    plain version, and a second launch on the same inputs bit-identical
    (no float atomics)."""
    args = _problem(MK, 3, 37, MK, cuda)
    want = lk.maximize_lambda_restarts_plain(*args)
    for geo in lk._candidate_geometries(MK):
        before = lk.LAUNCHES
        got = lk._launch_at(geo, *args)
        again = lk._launch_at(geo, *args)
        torch.cuda.synchronize()
        assert lk.LAUNCHES == before + 2
        assert torch.equal(got, again), geo
        assert float((got - want).abs().max()) <= ATOL, geo


@pytest.mark.parametrize("MK", [14, 19, 40])
def test_kernel_keeps_a_dead_lane_dead_and_apart_on_every_layout(cuda, MK):
    """An all-NaN Σ⁻¹ makes its lane's λ NaN and leaves the other lanes
    bit-identical, on each layout."""
    args = _problem(17, 3, 70, MK, cuda)
    invS = args[5].clone()
    invS[1] = torch.nan
    for geo in lk._candidate_geometries(MK):
        alive = lk._launch_at(geo, *args, n_iter=3, cg_iter=4, polish_iter=1)
        got = lk._launch_at(geo, *args[:5], invS, n_iter=3, cg_iter=4, polish_iter=1)
        assert torch.isnan(got[1]).all(), geo
        assert torch.equal(got[[0, 2]], alive[[0, 2]]), geo


# sha256 (first 16 hex digits) of the λ kernel's output bytes before the
# group solve batched its reductions (one-warp-group-per-problem launches,
# NVIDIA H100 80GB HBM3, nvcc 12.9), on `_problem(R·D + MK, R, D, MK)`:
# (R, D, MK, budgets) -> digest.
GROUP_SOLVE_DIGESTS = {
    (1, 560, 14, "cold"): "db2fdfbcbc5aacc2", (1, 560, 14, "cavi"): "ed7fc7dd681233b6",
    (1, 560, 19, "cold"): "c18aae415aafa1e7", (1, 560, 19, "cavi"): "6ea599b81fb2dbb1",
    (2, 560, 14, "cold"): "297e7a249512abe9", (2, 560, 14, "cavi"): "570b508327df3abc",
    (1, 300, 40, "cold"): "7d69a15eb3c35292", (1, 300, 40, "cavi"): "9a77ed0c9a960fdd",
}


@pytest.mark.parametrize("key", sorted(GROUP_SOLVE_DIGESTS))
def test_few_problem_layout_is_bit_identical_to_the_unbatched_group_solve(cuda, key):
    """The batched reductions sum each value in the same order as before,
    so the warp and block group layouts give the same bits."""
    import hashlib

    R, D, MK, budgets = key
    args = _problem(R * D + MK, R, D, MK, cuda)
    kw = dict(n_iter=3, cg_iter=4, polish_iter=1) if budgets == "cavi" else {}
    assert lk.launch_geometry(R, D, MK).layout in ("warp", "block")
    got = lk.maximize_lambda_restarts(*args, **kw)
    digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
    assert digest == GROUP_SOLVE_DIGESTS[key]


def _eta_problem(seed, R, D, K, device, zero_count=False):
    """The λ problems of `_problem` with a starting λ near 0, per-document
    counts N (D, M) and, optionally, a document with no counts in its second
    modality."""
    rng = np.random.default_rng(seed)
    MK = sum(K)
    lam0, nu, _, st, mu, invS = _problem(seed, R, D, MK, "cpu")
    lam = torch.as_tensor(0.5 * rng.standard_normal((R, D, MK)), dtype=torch.float32)
    N = torch.as_tensor(rng.integers(0, 200, (D, len(K))), dtype=torch.float32)
    if zero_count:
        N[0, 1] = 0.0
        st[:, 0, K[0]:K[0] + K[1]] = 0.0
    return [t.to(device) for t in (lam, nu, N, st, mu, invS)]


CAVI = dict(n_iter=3, cg_iter=4, polish_iter=1, nu_n_iter=4)
# launch_geometry's few-problem crossover at MK 40 and 128 (the block
# layout below, split4 or split8 from there)
BLOCK_CROSS = {40: ek.BLOCK_MAX_PROBLEMS["split4", 10], 128: ek.BLOCK_MAX_PROBLEMS["split8", 16]}


@pytest.mark.parametrize("R, D, K, budgets, zero_count", [
    (100, 560, (7, 7), CAVI, False),
    (100, 560, (7, 7), {}, False),
    (100, 560, (20, 20), CAVI, False),
    (100, 560, (64, 64), CAVI, False),
    (3, 37, (3, 4, 5), {}, False),
    (2, 9, (3, 2), {}, True),
    (3, 29, (40, 50, 38), {}, False),
])
def test_eta_kernel_matches_plain(cuda, R, D, K, budgets, zero_count):
    """ζ and ν within rtol 2e-5, atol 2e-6 (the JAX suite's bound for its
    η kernel), λ within the λ kernel's 5e-5."""
    args = _eta_problem(R * D + sum(K), R, D, K, cuda, zero_count)
    before = ek.LAUNCHES
    got = ek.estep_eta_fused(*args, K, **budgets)
    want = ek.estep_eta_fused_plain(*args, K, **budgets)
    torch.cuda.synchronize()
    assert ek.LAUNCHES == before + 1
    assert all(torch.isfinite(g).all() for g in got)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
    assert float((got[2] - want[2]).abs().max()) <= ATOL


def test_eta_kernel_keeps_a_dead_lane_dead_and_apart(cuda):
    """An all-NaN Σ⁻¹ (a failed Cholesky) makes its lane's ν and λ NaN and
    leaves the other lanes as they are without it."""
    K = (7, 7)
    args = _eta_problem(11, 3, 40, K, cuda)
    alive = ek.estep_eta_fused(*args, K, **CAVI)
    invS = args[5].clone()
    invS[1] = torch.nan
    got = ek.estep_eta_fused(*args[:5], invS, K, **CAVI)
    assert torch.isnan(got[1][1]).all() and torch.isnan(got[2][1]).all()
    for g, a in zip(got, alive):
        assert torch.equal(g[[0, 2]], a[[0, 2]])


@pytest.mark.parametrize("R, D, K, budgets, layout", [
    (100, 560, (7, 7), CAVI, "thread"),  # MK 14: P = 14, the BRCA main path
    (100, 560, (8, 8), CAVI, "thread"),  # MK 16: the thread layout's last MK
    (100, 560, (9, 8), CAVI, "pair"),  # MK 17: the pair's first, P = 10
    (100, 560, (14, 14), CAVI, "pair"),  # MK 28: the pair's last at P = 14
    # MK 29–32 on many problems at the cold defaults: at the CAVI budgets a
    # near-tie of the line search flips there (test_eta_kernel_at_a_line_search_tie)
    (100, 560, (15, 14), {}, "thread"),  # MK 29: one thread at P = 32
    (90, 560, (16, 16), {}, "pair"),  # MK 32, three waves of the pair at P = 16
    (3, 50, (16, 16), {}, "warp"),  # MK 32: the warp layout's last
    (3, 50, (17, 16), {}, "block"),  # MK 33 at few problems: the block layout
    # MK 33–128 on restart batches: split4 to MK 64, split8 beyond, each P
    (30, 557, (17, 16), CAVI, "split4"),  # MK 33: split4's first, P = 10
    (30, 557, (20, 20), CAVI, "split4"),  # MK 40: P = 10's last
    (30, 557, (21, 20), CAVI, "split4"),  # MK 41: P = 12
    (30, 557, (32, 32), CAVI, "split4"),  # MK 64: split4's last, P = 16
    (30, 557, (33, 32), CAVI, "split8"),  # MK 65: split8's first, P = 10
    (30, 557, (56, 56), CAVI, "split8"),  # MK 112: P = 14
    (30, 557, (64, 64), CAVI, "split8"),  # MK 128: P = 16
    # either side of the few-problem crossover at MK 40 and 128
    (1, BLOCK_CROSS[40] - 1, (20, 20), CAVI, "block"),
    (1, BLOCK_CROSS[40], (20, 20), CAVI, "split4"),
    (1, BLOCK_CROSS[128] - 1, (64, 64), CAVI, "block"),
    (1, BLOCK_CROSS[128], (64, 64), CAVI, "split8"),
    (1, 560, (7, 7), CAVI, "warp"),  # R = 1: WarpGroup<16>
    (1, 9, (7, 7), {}, "warp"),  # a single block with padding documents
    (16, 560, (7, 7), CAVI, "warp"),  # either side of the crossover at MK 14
    (18, 560, (7, 7), CAVI, "thread"),
    (1, 9099, (7, 7), CAVI, "warp"), (1, 9100, (7, 7), CAVI, "thread"),
    (1, 20479, (8, 8), CAVI, "warp"), (1, 20480, (8, 8), CAVI, "thread"),
    (1, 2800, (7, 7, 5), CAVI, "warp"),  # PCAWG at R = 1: WarpGroup<32>
    (1, 3167, (9, 8), CAVI, "warp"), (1, 3168, (9, 8), CAVI, "pair"),
    (1, 4351, (13, 12), CAVI, "warp"), (1, 4352, (13, 12), CAVI, "pair"),
    (1, 6143, (16, 15), {}, "warp"), (1, 6144, (16, 15), {}, "pair"),
    (1, 10239, (16, 16), {}, "warp"), (1, 10240, (16, 16), {}, "pair"),
    (1, 50689, (15, 14), {}, "thread"),  # past the pair's third wave at P = 16
])
def test_eta_kernel_matches_plain_at_the_layout_boundaries(cuda, R, D, K, budgets, layout):
    """The tolerances of test_eta_kernel_matches_plain, at either side of
    each layout boundary of ops/estep_kernel.launch_geometry."""
    assert ek.launch_geometry(R, D, sum(K)).layout == layout
    args = _eta_problem(R * D + 7 * sum(K), R, D, K, cuda)
    got = ek.estep_eta_fused(*args, K, **budgets)
    want = ek.estep_eta_fused_plain(*args, K, **budgets)
    torch.cuda.synchronize()
    assert all(torch.isfinite(g).all() for g in got)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
    assert float((got[2] - want[2]).abs().max()) <= ATOL


def test_eta_kernel_at_a_line_search_tie(cuda):
    """At the CAVI budgets from a cold start (λ ~ 0.5·N(0, 1), Newton 3),
    one problem of these 6,144 at MK 31 sits at a near-tie of the line
    search: the step a layout takes there depends on the order of its sums.
    The plain version in float32 and in float64 and one thread per problem
    take one step, the pair (P = 16) and the warp group the other, about
    2e-3 apart in λ.
    Every other problem agrees within ATOL on every layout, and with the
    cold defaults (Newton 7) that problem does too."""
    R, D, K = 1, 6144, (16, 15)
    args = _eta_problem(R * D + 7 * sum(K), R, D, K, cuda)
    want = ek.estep_eta_fused_plain(*args, K, **CAVI)[2]
    want64 = ek.estep_eta_fused_plain(*(a.double() for a in args), K, **CAVI)[2]
    assert float((want64 - want.double()).abs().max()) <= ATOL
    apart = {}
    for geo in ek._candidate_geometries(sum(K)):
        gap = (ek._launch_at(geo, *args, K, **CAVI)[2] - want).abs().amax(-1)[0]
        apart[geo.layout + str(geo.docs_per_block)] = torch.nonzero(gap > ATOL).flatten().tolist()
        assert float(gap.max()) < 1e-2, geo
        cold = ek._launch_at(geo, *args, K)[2] - ek.estep_eta_fused_plain(*args, K)[2]
        assert float(cold.abs().max()) <= ATOL, geo
    tie = apart["pair64"]
    assert len(tie) == 1 and apart["thread64"] == [] and apart["warp2"] == apart["warp8"] == tie


def test_eta_kernel_at_a_line_search_tie_above_MK_32(cuda):
    """At the CAVI budgets from a cold start, one problem of these 560,000
    at MK 40 sits at a near-tie of the line search: the plain version in
    float32 and in float64 and split4 take one step, the block layout the
    other. Every other problem agrees within ATOL on both layouts, and with
    the cold defaults (Newton 7) that problem's restart does too."""
    R, D, K = 1000, 560, (20, 20)
    tie = 115616  # restart 206, document 256
    args = _eta_problem(2, R, D, K, cuda)
    want = ek.estep_eta_fused_plain(*args, K, **CAVI)[2]
    want64 = ek.estep_eta_fused_plain(*(a.double() for a in args), K, **CAVI)[2]
    assert float((want64 - want.double()).abs().max()) <= ATOL
    cold_want = ek.estep_eta_fused_plain(*args, K)[2][tie // D]
    apart = {}
    for geo in ek._candidate_geometries(sum(K)):
        gap = (ek._launch_at(geo, *args, K, **CAVI)[2] - want).abs().amax(-1).flatten()
        apart[geo.layout] = torch.nonzero(gap > ATOL).flatten().tolist()
        assert float(gap.max()) < 1e-2, geo
        cold = ek._launch_at(geo, *args, K)[2][tie // D] - cold_want
        assert float(cold.abs().max()) <= ATOL, geo
    assert apart == {"split4": [], "block": [tie]}


# thread and warp; pair P = 10 (modality 1 straddling the pair) with thread
# P = 20 and warp; pair P = 16 with thread P = 32 and warp; split4 at P =
# 10, 12, 14, 16 and split8 at the same P, each with block; D = 70 ragged
# in every layout
@pytest.mark.parametrize("K", [(7, 7), (10, 10), (9, 9), (16, 16), (20, 20), (24, 24), (28, 28),
                               (32, 32), (33, 32), (48, 48), (56, 56), (64, 64)])
def test_eta_kernel_keeps_a_dead_lane_dead_on_every_layout(cuda, K):
    """On every layout of _candidate_geometries: an all-NaN Σ⁻¹ makes its
    lane's ν and λ NaN and leaves the other lanes' bits as they are
    without it."""
    args = _eta_problem(13, 3, 70, K, cuda)
    invS = args[5].clone()
    invS[1] = torch.nan
    for geo in ek._candidate_geometries(sum(K)):
        alive = ek._launch_at(geo, *args, K, **CAVI)
        got = ek._launch_at(geo, *args[:5], invS, K, **CAVI)
        assert torch.isnan(got[1][1]).all() and torch.isnan(got[2][1]).all(), geo
        for g, a in zip(got, alive):
            assert torch.equal(g[[0, 2]], a[[0, 2]]), geo


@pytest.mark.parametrize("R, D, K, budgets, zero_count", [
    (100, 448, (9, 9), CAVI, False),  # K selection's MK 18: modality 1 straddles a pair
    (100, 560, (10, 9), CAVI, False),  # MK 19
    (3, 101, (7, 7, 5), {}, False),  # PCAWG's K, three modalities over a pair
    (3, 37, (11, 10), {}, False),  # MK 21: pair P = 12, thread P = 24
    (2, 70, (13, 12), {}, False),  # MK 25: pair P = 14, thread P = 28
    (3, 50, (16, 16), {}, False),  # MK 32: pair P = 16, thread P = 32
    (2, 9, (9, 9), {}, True),  # a zero-count modality, padding documents
    (1, 560, (7, 7), CAVI, False),  # R = 1: thread P = 14, warp 16
    (1, 9, (7, 7), {}, False),  # one block, padding documents on every layout
    (3, 37, (3, 4, 5), {}, False),  # M = 3 in a warp group of 16
    # split4 at P = 10, 12, 14, 16 and split8 at the same P, and block, at
    # a ragged D; three modalities straddling the parts
    (3, 37, (20, 20), {}, False),
    (2, 70, (24, 24), {}, False),
    (3, 50, (28, 28), {}, False),
    (2, 41, (32, 32), {}, False),
    (3, 37, (33, 32), {}, False),
    (2, 29, (48, 48), {}, False),
    (3, 19, (56, 56), {}, False),
    (2, 23, (64, 64), {}, False),
    (3, 101, (20, 12, 8), CAVI, False),
    (2, 9, (20, 20), {}, True),  # a zero-count modality, padding documents
])
def test_eta_kernel_matches_plain_on_every_layout(cuda, R, D, K, budgets, zero_count):
    """Each launch of _candidate_geometries: the tolerances of
    test_eta_kernel_matches_plain, and a second launch on the same inputs
    bit-identical."""
    args = _eta_problem(R * D + 11 * sum(K), R, D, K, cuda, zero_count)
    want = ek.estep_eta_fused_plain(*args, K, **budgets)
    for geo in ek._candidate_geometries(sum(K)):
        before = ek.LAUNCHES
        got = ek._launch_at(geo, *args, K, **budgets)
        again = ek._launch_at(geo, *args, K, **budgets)
        torch.cuda.synchronize()
        assert ek.LAUNCHES == before + 2
        assert all(torch.equal(g, a) for g, a in zip(got, again)), geo
        assert all(torch.isfinite(g).all() for g in got), geo
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6, msg=lambda m: f"{geo}: {m}")
        assert float((got[2] - want[2]).abs().max()) <= ATOL, geo


def test_eta_wrapper_rejects_wrong_dtype_shape_or_device(cuda):
    args = _eta_problem(3, 2, 8, (3, 2), cuda)
    with pytest.raises(TypeError, match="float32"):
        ek.estep_eta_fused(*(a.double() for a in args), (3, 2))
    with pytest.raises(ValueError, match="is on"):
        ek.estep_eta_fused(*args[:5], args[5].cpu(), (3, 2))
    with pytest.raises(ValueError, match="must have shape"):
        ek.estep_eta_fused(args[0], args[1], args[2][:, :1], *args[3:], (3, 2))


def test_solve_eta_sends_float32_to_the_eta_kernel_and_float64_to_the_split_route(cuda):
    K = (7, 7)
    lam, nu, N, st, mu, invS = _eta_problem(5, 2, 40, K, cuda)
    config = mt.MMCTMConfig(K=K, V=(96, 48), D=40, dtype=torch.float32)
    eta, lam_before = ek.LAUNCHES, lk.LAUNCHES
    got32 = ctm_base.solve_eta(lam, nu, N, st, mu, invS, config)
    assert (ek.LAUNCHES, lk.LAUNCHES) == (eta + 1, lam_before)
    config64 = mt.MMCTMConfig(K=K, V=(96, 48), D=40, dtype=torch.float64, **{
        "lambda_n_iter": 3, "lambda_cg_iter": 4, "lambda_polish_iter": 1, "nu_n_iter": 4})
    got64 = ctm_base.solve_eta(*(t.double() for t in (lam, nu, N, st, mu, invS)), config64)
    assert (ek.LAUNCHES, lk.LAUNCHES) == (eta + 1, lam_before)
    for a, b in zip(got32, got64):
        torch.testing.assert_close(a.double(), b, rtol=1e-4, atol=ATOL)


def test_dispatch_sends_float32_to_the_kernel_and_float64_to_the_plain_solver(cuda):
    args = _problem(2, 2, 40, 14, cuda)
    before = lk.LAUNCHES
    got32 = ctm_base.solve_lambda(*args, n_iter=3, cg_iter=4, polish_iter=1)
    assert lk.LAUNCHES == before + 1
    got64 = ctm_base.solve_lambda(*(a.double() for a in args), n_iter=3, cg_iter=4, polish_iter=1)
    assert lk.LAUNCHES == before + 1 and got64.dtype == torch.float64
    assert float((got32.double() - got64).abs().max()) <= ATOL


def test_dispatch_above_the_kernel_limit_takes_the_plain_solver(cuda):
    args = _problem(4, 1, 6, 129, cuda)
    before = lk.LAUNCHES
    got = ctm_base.solve_lambda(*args, n_iter=2, cg_iter=4, polish_iter=1)
    assert lk.LAUNCHES == before and torch.isfinite(got).all()


def test_wrong_dtype_or_mixed_devices_raise(cuda):
    args = _problem(3, 1, 8, 5, cuda)
    with pytest.raises(TypeError, match="float32"):
        lk.maximize_lambda_restarts(*(a.double() for a in args))
    with pytest.raises(ValueError, match="is on"):
        lk.maximize_lambda_restarts(*args[:5], args[5].cpu())


def _theta_inputs(seed, R, D, V, K, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((R, D, K)) * 2.0, rng.standard_normal((R, V, K)) - 4.0,
              rng.integers(0, 30, (D, V)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrays]


@pytest.mark.parametrize("R, D, V, K", [
    (100, 560, 96, 7), (100, 560, 48, 7), (3, 33, 128, 11), (2, 8, 5, 2), (2, 40, 24, 128),
    (1, 560, 96, 7), (7, 101, 96, 7), (3, 29, 128, 128),
])
def test_theta_kernel_matches_plain_and_repeats_bit_identically(cuda, R, D, V, K):
    args = _theta_inputs(R * D + V + K, R, D, V, K, cuda)
    before = tk.LAUNCHES
    got = tk.theta_moments_fused(*args)
    again = tk.theta_moments_fused(*args)
    want = tk.theta_moments_fused_plain(*args)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("V", [96, 48])
def test_theta_kernel_is_one_device_kernel_per_call(cuda, V):
    """The last block of each restart adds the scatter: no second kernel,
    no memset of the arrival counters."""
    from torch.profiler import ProfilerActivity, profile

    args = _theta_inputs(9, 100, 560, V, 7, cuda)
    tk.theta_moments_fused(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tk.theta_moments_fused(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "theta_moments_kernel" in kernels[0]


def test_theta_kernel_reads_strided_views(cuda):
    """λ's block of a wider (R, D, MK) tensor, and logw as E[ln ϕ]ᵀ, the
    transpose of a (R, K, V) tensor."""
    lam, logw, X = _theta_inputs(5, 3, 50, 20, 11, cuda)
    full = torch.cat([torch.randn(3, 50, 4, device=cuda), lam], dim=-1)
    got = tk.theta_moments_fused(full[..., 4:], logw.mT.contiguous().mT, X)
    want = tk.theta_moments_fused(lam, logw, X)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_theta_moments_dispatch_on_the_card(cuda):
    """CUDA float32 modalities launch the kernel; float64 keeps the
    factorized schedule, which agrees."""
    config = mt.MMCTMConfig(K=(7, 3), V=(96, 48), D=40, dtype=torch.float32)
    lam, logw0, X0 = _theta_inputs(7, 2, 40, 96, 7, cuda)
    _, logw1, X1 = _theta_inputs(8, 2, 40, 48, 3, cuda)
    lam = torch.cat([lam, torch.randn(2, 40, 3, device=cuda)], dim=-1)
    before = tk.LAUNCHES
    st32, sc32 = ctm_base.theta_moments(lam, (logw0, logw1), (X0, X1), config)
    assert tk.LAUNCHES == before + 2
    st64, sc64 = ctm_base.theta_moments(lam.double(), (logw0.double(), logw1.double()),
                                        (X0.double(), X1.double()), config)
    assert tk.LAUNCHES == before + 2
    torch.testing.assert_close(st32.double(), st64, rtol=2e-5, atol=1e-4)
    for a, b in zip(sc32, sc64):
        torch.testing.assert_close(a.double(), b, rtol=2e-5, atol=1e-4)


def test_immctm_fit_on_the_card_matches_the_cpu_in_float64(cuda):
    """3 lanes x 10 iterations of a small IMMCTM: float32 on the card (the η
    and θ kernels) against float64 on the CPU (plain path), from the same seed and
    with the same solver budgets, so only the precision differs."""
    from multimodalmusig_tpu_torch.models import ilda, immctm

    rng = np.random.default_rng(3)
    features = [np.array([[a, b] for a in (1, 2, 3) for b in (1, 2, 3, 4)]),
                np.array([[a, b] for a in (1, 2) for b in (1, 2, 3)])]
    J = ((3, 4), (2, 3))
    X = [rng.integers(0, 6, (30, len(f))).astype(np.float64) for f in features]
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        config = immctm.IMMCTMConfig(K=(3, 2), V=(12, 6), D=30, dtype=dtype, J=J,
                                     lambda_n_iter=3, lambda_cg_iter=4, lambda_polish_iter=1,
                                     nu_n_iter=4)
        F = tuple(ilda.feature_onehots(f, j, dtype, device) for f, j in zip(features, J))
        state = immctm.init(torch.Generator().manual_seed(1), config, [[0.1, 0.1]] * 2,
                            restarts=3, device=device)
        eta_before, theta_before = ek.LAUNCHES, tk.LAUNCHES
        res = mt.fit_immctm_restarts_from_states(state, X, F, config, maxiter=10, tol=0.0)
        if device == cuda:
            assert ek.LAUNCHES - eta_before == 10
            assert tk.LAUNCHES - theta_before == 20
        out.append(res.ll_history.cpu().double().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4)


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
    model = mt.MMCTM([3, 2], [0.1, 0.1], [12, 12], docs)
    assert model.device.type == "cuda"
    before = ek.LAUNCHES
    history = model.fit(maxiter=15, tol=0.0)
    assert ek.LAUNCHES - before == 15 and len(history) == 15
    assert np.isfinite(model.ll).all() and np.isfinite(model.elbo)


def _poisson_docs():
    """24 documents of Poisson counts over V = (10, 8), as
    tests/test_torch_two_stage.py makes them."""
    rng = np.random.default_rng(0)
    return [rng.poisson(rng.gamma(1.0, 3.0, (24, 1)) * rng.dirichlet(np.ones(v), 24) * 5)
            .astype(np.float64) for v in (10, 8)]


def test_compacted_fit_on_the_card_matches_the_cpu_in_float64(cuda):
    """6 lanes to tol 1e-4 with compaction at 25 and 35 iterations: float32
    on the card (the η kernel, once per iteration) against float64 on the
    CPU. A lane's final ll may come one iteration apart, so rtol 2e-3."""
    X = _poisson_docs()
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24, dtype=dtype)
        before = ek.LAUNCHES
        res = mt.fit_restarts(3, X, config, [0.1, 0.1], restarts=6, maxiter=80, tol=1e-4,
                              compact_schedule=(25, 10), device=device)
        if device == cuda:
            assert ek.LAUNCHES - before >= int(res.n_iters.max())
        out.append(res)
    np.testing.assert_allclose(out[0].ll.cpu().double().numpy(), out[1].ll.numpy(), rtol=2e-3)
    assert (np.abs(out[0].n_iters.cpu().numpy() - out[1].n_iters.numpy()) <= 2).all()


def test_two_stage_fit_on_the_card_matches_the_cpu_in_float64(cuda):
    """The two-stage fit from one seed: the same stage-1 winners (read from
    f64 re-scores) and the selected model's ll within rtol 2e-3."""
    X = _poisson_docs()
    picks = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24, dtype=dtype)
        info = {}
        best, _, _, _ = mt.two_stage_fit(8, X, config, [0.1, 0.1], restarts=6, maxiter=80,
                                         selection_info=info, device=device)
        picks.append((info["stage1_winners"], best.ll[0].cpu().double().numpy()))
    np.testing.assert_array_equal(picks[0][0], picks[1][0])
    np.testing.assert_allclose(picks[0][1], picks[1][1], rtol=2e-3)


@pytest.mark.parametrize("R, D, K", [
    (1, 560, (7,)),  # predict_modality_eta on BRCA: one observed modality, R = 1
    (100, 560, (7,)),  # one modality (a CTM) on restart batches
    (1, 112, (7, 7)),  # fit_heldout of the 112 held-out documents: two blocks
    (1, 9, (3,)),
    (100, 448, (5, 5)),  # K selection's MK 10: stage 1 on the 448 training documents
    (1, 112, (5, 5)),  # and its held-out fit
    (100, 448, (9, 9)),  # K selection's MK 18
    (1, 112, (9, 9)),
])
def test_eta_kernel_at_the_inference_shapes(cuda, R, D, K):
    """M = 1 (ζ one masked sum, N of shape (D, 1)), R = 1 at small D and the
    K selection's MK 10 and 18, at the tolerances of
    test_eta_kernel_matches_plain."""
    args = _eta_problem(R * D + 5 * sum(K), R, D, K, cuda)
    before = ek.LAUNCHES
    got = ek.estep_eta_fused(*args, K, **CAVI)
    want = ek.estep_eta_fused_plain(*args, K, **CAVI)
    torch.cuda.synchronize()
    assert ek.LAUNCHES == before + 1 and got[0].shape == (R, D, len(K))
    assert all(torch.isfinite(g).all() for g in got)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
    assert float((got[2] - want[2]).abs().max()) <= ATOL


@pytest.mark.parametrize("R, D, V, K", [(1, 560, 96, 9), (100, 448, 48, 5), (2, 112, 96, 9)])
def test_theta_kernel_at_the_k_selection_shapes(cuda, R, D, V, K):
    """K = 9 (the 16-wide instantiation) and K = 5, with log-weights near -30
    on every fifth (rare) term in all topics but the first, as a fitted ln ϕ
    has them: the topic that owns a rare term dominates its cells."""
    lam, logw, X = _theta_inputs(R + D + V + K, R, D, V, K, cuda)
    logw[:, ::5, 1:] -= 26.0
    got = tk.theta_moments_fused(lam, logw, X)
    again = tk.theta_moments_fused(lam, logw, X)
    want = tk.theta_moments_fused_plain(lam, logw, X)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a) and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4)


# K above 8: the chunk layout (csrc/theta_moments.cu), every candidate the
# rule weighs (ops/theta_kernel._candidate_geometries)
CHUNK_K = (9, 12, 20, 33, 40, 64, 65, 128)


def _theta_holds(got, again, want, label):
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a), label
        assert torch.isfinite(g).all(), label
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4, msg=lambda m: f"{label}: {m}")


@pytest.mark.parametrize("K", CHUNK_K)
@pytest.mark.parametrize("R, D, V, rare", [(3, 101, 96, False), (1, 560, 48, False),
                                           (2, 37, 24, False), (7, 101, 96, True),
                                           (1, 560, 96, True)])
def test_theta_kernel_above_K_8_matches_plain_on_every_candidate(cuda, R, D, V, K, rare):
    """Ragged D, R = 1, the vocab ranks' V = 24, and log-weights near -30
    on every fifth (rare) term in all topics but the first; each candidate
    layout within rtol 2e-5, atol 1e-4 of plain, a repeat bit-identical."""
    lam, logw, X = _theta_inputs(R * D + V + K, R, D, V, K, cuda)
    if rare:
        logw[:, ::5, 1:] -= 26.0
    want = tk.theta_moments_fused_plain(lam, logw, X)
    for geo in tk._candidate_geometries(R, D, V, K):
        got = tk._launch_at(geo, lam, logw, X)
        again = tk._launch_at(geo, lam, logw, X)
        torch.cuda.synchronize()
        _theta_holds(got, again, want, tuple(geo))


@pytest.mark.parametrize("K", [20, 64, 128])
def test_theta_kernel_above_K_8_reads_strided_views(cuda, K):
    """λ's block of a wider (R, D, MK) tensor, and logw as E[ln ϕ]ᵀ."""
    lam, logw, X = _theta_inputs(K, 3, 50, 48, K, cuda)
    full = torch.cat([torch.randn(3, 50, 4, device=cuda), lam], dim=-1)
    got = tk.theta_moments_fused(full[..., 4:], logw.mT.contiguous().mT, X)
    want = tk.theta_moments_fused(lam, logw, X)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("R, D, V, K", [(2, 90, 96, 20), (1, 560, 48, 64), (3, 41, 24, 128)])
def test_theta_kernel_above_K_8_on_cells_far_below_their_row_maxima(cuda, R, D, V, K):
    """Cells whose best topic sits 100 nats below max_k λ + max_k logw: the
    factorized products underflow, so their blocks take the exact path
    (the joint max per cell), and match plain; a dead lane (NaN λ) is NaN
    and leaves the other lanes' bits as they were."""
    lam, logw, X = _theta_inputs(R + D + V + K, R, D, V, K, cuda)
    lam[0, 1, :], lam[0, 1, 0] = -100.0, 0.0
    logw[0, 2, :], logw[0, 2, 0] = 0.0, -100.0
    want = tk.theta_moments_fused_plain(lam, logw, X)
    for geo in tk._candidate_geometries(R, D, V, K):
        got = tk._launch_at(geo, lam, logw, X)
        again = tk._launch_at(geo, lam, logw, X)
        torch.cuda.synchronize()
        _theta_holds(got, again, want, tuple(geo))
    if R > 1:
        dead = lam.clone()
        dead[1, 3, 0] = torch.nan
        got = tk.theta_moments_fused(dead, logw, X)
        alive = tk.theta_moments_fused(lam, logw, X)
        others = [i for i in range(R) if i != 1]
        assert torch.isnan(got[0][1, 3]).all() and torch.isnan(got[1][1]).all()
        assert torch.equal(got[0][others], alive[0][others])
        assert torch.equal(got[1][others], alive[1][others])


@pytest.mark.parametrize("K", [20, 64])
def test_theta_kernel_above_K_8_is_one_device_kernel_per_call(cuda, K):
    """The clusters' sums and the last cluster's: no second kernel, no
    memset of the arrival counters."""
    from torch.profiler import ProfilerActivity, profile

    args = _theta_inputs(9, 100, 560, 96, K, cuda)
    tk.theta_moments_fused(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tk.theta_moments_fused(*args)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "theta_moments_kernel" in kernels[0]


def _lda_theta_inputs(seed, R, D, V, K, device):
    """LDA's θ-kernel inputs, E[ln θ] and E[ln β], from γ = α + counts and
    λ = η + counts split over the topics by weights u^8 (α = η = 0.1), and
    counts 0..29, from NumPy."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 30, (D, V)).astype(np.float64)

    def split(totals, shape):
        w = rng.uniform(size=shape) ** 8
        return 0.1 + totals * w / w.sum(axis=-1, keepdims=True)

    gamma = torch.as_tensor(split(X.sum(axis=1)[None, :, None], (R, D, K)))
    lam = torch.as_tensor(split(X.sum(axis=0)[None, :, None], (R, V, K)))
    dg = torch.special.digamma
    elog_theta = dg(gamma) - dg(gamma.sum(dim=-1, keepdim=True))
    elog_beta = dg(lam) - dg(lam.sum(dim=-2, keepdim=True))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (elog_theta, elog_beta, X)]


# sha256 (first 16 hex digits) of the θ kernel's sumθ then scatter bytes at
# K ≤ 8 from the kernel before the chunk layout (NVIDIA H100 80GB HBM3,
# nvcc 12.9): the tile layout is unchanged, so are its bits.
THETA_TILE_DIGESTS = {
    (100, 560, 96, 7, "ctm"): "98a1e069484a19ae",
    (100, 560, 48, 7, "ctm"): "0806d8e6492d5a46",
    (100, 560, 96, 7, "lda"): "f574511c86db80d4",
}


def _theta_digest(key, device):
    R, D, V, K, logits = key
    make = _lda_theta_inputs if logits == "lda" else _theta_inputs
    args = make(R * D + V + K, R, D, V, K, device)
    st, sc = tk.theta_moments_fused(*args)
    data = st.cpu().numpy().tobytes() + sc.cpu().numpy().tobytes()
    return hashlib.sha256(data).hexdigest()[:16]


@pytest.mark.parametrize("key", sorted(THETA_TILE_DIGESTS))
def test_theta_kernel_at_K_8_or_less_keeps_its_bits(cuda, key):
    assert _theta_digest(key, cuda) == THETA_TILE_DIGESTS[key]


def mmctm_state_to(state, device, dtype=torch.float32):
    """An MMCTM state's tensors on `device` in `dtype`."""
    return type(state)(*(tuple(t.to(device, dtype) for t in x) if isinstance(x, tuple)
                         else x.to(device, dtype) for x in state))


def _trained_model():
    """A CPU float64 MMCTM fit of the 24 Poisson documents, 30 iterations."""
    X = _poisson_docs()
    docs = [[mt.make_count_matrix(X[m][d].astype(np.int64)) for m in range(2)]
            for d in range(24)]
    model = mt.MMCTM([3, 2], [0.1, 0.1], [10, 8], docs, dtype=torch.float64, device="cpu")
    model.fit(maxiter=30, tol=0.0, verbose=False)
    return model, docs


def test_inference_on_the_card_matches_the_cpu_in_float64(cuda):
    """30 iterations (tol 0) of each inference loop from one trained state:
    float32 on the card (one η launch per iteration, one θ launch per
    observed modality) against float64 on the CPU, with the same solver
    budgets, at chip_smoke.py's tolerances."""
    import dataclasses

    from chip_smoke import INFER_ETA_ATOL, INFER_LL_RTOL, INFER_PROPS_ATOL
    from multimodalmusig_tpu_torch.models import mmctm

    model, docs = _trained_model()
    test = docs[:8]
    budgets = dict(lambda_n_iter=3, lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4)
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        trained = mmctm_state_to(model.state, device, dtype)
        full = dataclasses.replace(model.config, dtype=dtype, **budgets)
        runs = {}
        before = (ek.LAUNCHES, tk.LAUNCHES)
        h = mt.MMCTM(model.K, model.alpha, model.V, test, dtype=dtype, device=device)
        r = mmctm.fit_heldout_states(trained, h.state, h.Xdense,
                                     dataclasses.replace(h.config, **budgets), maxiter=30, tol=0.0)
        runs["heldout"] = (torch.cat(mmctm.props_from(r.state.lam, full), -1), r.ll_history)
        for fg in (False, True):
            n = mt.MMCTM(model.K, model.alpha, model.V, docs, dtype=dtype, device=device)
            r = mmctm.transform_states(trained, n.state, n.Xdense,
                                       dataclasses.replace(n.config, **budgets), maxiter=30,
                                       tol=0.0, fit_gaussian=fg)
            runs[f"transform {fg}"] = (torch.cat(mmctm.props_from(r.state.lam, full), -1),
                                       r.ll_history)
        o = mt.MMCTM([3], [0.1], [10], [[doc[0]] for doc in test], dtype=dtype, device=device)
        eta, _, _ = mmctm.predict_modality_eta_states(
            trained, o.state, o.Xdense, 1, full, dataclasses.replace(o.config, **budgets),
            maxiter=30, tol=0.0)
        runs["predict"] = (eta, None)
        if device == cuda:  # 4 loops of 30 iterations: 2 + 2 + 2 + 1 θ launches each
            assert (ek.LAUNCHES - before[0], tk.LAUNCHES - before[1]) == (120, 210)
        out.append(runs)
    for name, (a, la) in out[0].items():
        b, lb = out[1][name]
        assert torch.isfinite(a).all(), name
        atol = INFER_ETA_ATOL if la is None else INFER_PROPS_ATOL
        assert float((a.cpu().double() - b).abs().max()) <= atol, name
        if la is not None:
            np.testing.assert_allclose(la.cpu().double().numpy(), lb.numpy(), rtol=INFER_LL_RTOL)


def test_inference_wrappers_run_on_the_models_card(cuda):
    """transform, fit_heldout and predict_modality_eta on a model held on the
    card: the new models lie there, and the kernels ran."""
    model, docs = _trained_model()
    card = mt.MMCTM(model.K, model.alpha, model.V, docs, device=cuda)
    card.state = mmctm_state_to(model.state, cuda)
    before = ek.LAUNCHES
    new = mt.transform(card, docs, fit_gaussian=True)
    heldout = mt.fit_heldout(docs[:8], card)
    eta = mt.predict_modality_eta([[doc[1]] for doc in docs[:8]], 1, card)
    assert new.device.type == cuda.type and heldout.state.lam.device.type == cuda.type
    assert np.isfinite(new.ll).all() and np.isfinite(heldout.ll).all()
    assert np.isfinite(np.stack(eta)).all() and ek.LAUNCHES - before >= 33


def _lda_problem(n_docs=60):
    """The first `n_docs` BRCA-EU SNV documents (V = 96), and the
    substitution × context features of their terms (J = (6, 16)) as
    chip_smoke.py derives them."""
    from chip_smoke import brca_features, load_brca

    X, terms = load_brca()
    return ([mt.make_count_matrix(X[0][d]) for d in range(n_docs)],
            brca_features(*terms)[0])


@pytest.mark.parametrize("family", ["LDA", "ILDA"])
def test_lda_step_on_the_card_matches_the_plain_route(cuda, family, monkeypatch):
    """One CAVI step of 7 restart lanes (K = 7) 15 iterations into a fit, in
    float32 on the card: through the θ kernel (two launches) against the
    factorized schedule on the card, at the θ kernel's tolerance."""
    from multimodalmusig_tpu_torch.models import ilda, lda

    docs, feats = _lda_problem()
    if family == "LDA":
        model = mt.LDA(7, 0.1, 0.1, docs, device=cuda)
        cfg, step = model.config, lda.fit_step_fn(model.Xdense, model.config)
        state = lda.init(torch.Generator().manual_seed(2), cfg, restarts=7, device=cuda)
        state = lda.fit(state, model.Xdense, cfg, maxiter=15, tol=0.0).state
    else:
        model = mt.ILDA(7, 0.1, 0.1, feats, docs, device=cuda)
        cfg, step = model.config, ilda.fit_step_fn(model.Xdense, model.F, model.config)
        state = ilda.init(torch.Generator().manual_seed(2), cfg, restarts=7, device=cuda)
        state = ilda.fit(state, model.Xdense, model.F, cfg, maxiter=15, tol=0.0).state
    before = tk.LAUNCHES
    with ctm_base.full_f32_matmuls():
        got_state, got_ll = step(state)
        torch.cuda.synchronize()
        assert tk.LAUNCHES - before == 2
        monkeypatch.setattr(ctm_base, "_theta_route", lambda *a: "factorized")
        want_state, want_ll = step(state)
    assert tk.LAUNCHES - before == 2
    torch.testing.assert_close(got_state.gamma, want_state.gamma, rtol=2e-5, atol=1e-4)
    for g, w in zip(*((s.lam if isinstance(s.lam, tuple) else (s.lam,))
                      for s in (got_state, want_state))):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(got_ll, want_ll, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("family", ["LDA", "ILDA"])
def test_lda_loops_launch_the_theta_kernel_per_iteration(cuda, family):
    """A fit launches the θ kernel twice per CAVI iteration (γ's moments,
    then λ's); transform and fit_heldout once per iteration (γ's only). The
    card fit agrees with float64 on the CPU from the same seed."""
    docs, feats = _lda_problem()
    args = (7, 0.1, 0.1) + ((feats,) if family == "ILDA" else ()) + (docs,)
    cls = mt.LDA if family == "LDA" else mt.ILDA
    model = cls(*args, device=cuda)
    before = tk.LAUNCHES
    history = model.fit(maxiter=12, tol=0.0, verbose=False)
    assert tk.LAUNCHES - before == 24 and len(history) == 12
    cpu = cls(*args, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(history, cpu.fit(maxiter=12, tol=0.0, verbose=False), rtol=1e-4)
    before = tk.LAUNCHES
    theta = mt.transform(model, docs[:20], maxiter=10, tol=0.0)
    assert tk.LAUNCHES - before == 10 and theta.shape == (7, 20) and np.isfinite(theta).all()
    before = tk.LAUNCHES
    heldout = mt.fit_heldout(docs[20:], model, maxiter=9)  # no convergence test before 10
    assert tk.LAUNCHES - before == 9 and heldout.state.gamma.device.type == "cuda"
    assert np.isfinite(heldout.ll) and np.isfinite(heldout.elbo)


@pytest.mark.parametrize("family", ["LDA", "ILDA"])
def test_lda_restarts_on_the_card_pick_a_finite_lane(cuda, family):
    """The best-of-8 restart fit on the card, uncut and auto-compacted: two
    θ launches per iteration of the longest lane at least, every lane and
    the pick finite (the pick read from f64 re-scores on the card)."""
    docs, feats = _lda_problem()
    fit = mt.fit_lda_restarts if family == "LDA" else mt.fit_ilda_restarts
    args = (7, 0.1, 0.1) + ((feats,) if family == "ILDA" else ()) + (docs,)
    before = tk.LAUNCHES
    model = fit(*args, restarts=8, maxiter=60, tol=1e-4)
    res = model.restart_result
    assert tk.LAUNCHES - before >= 2 * int(res.n_iters.max())
    assert model.device.type == "cuda" and np.isfinite(model.ll)
    assert torch.isfinite(res.ll).all()
    auto = fit(*args, restarts=8, maxiter=60, tol=1e-4, compact_schedule="auto")
    assert auto.compact_info["pilot_restarts"] == 4 and np.isfinite(auto.ll)


def _launch_counts(info):
    return [(r["estep_eta"], r["lambda_newton"], r["theta_moments"]) for r in info["launches"]]


@pytest.mark.parametrize("devices", [["cuda:0"], ["cuda:0", "cuda:0"]], ids=["nccl", "gloo"])
def test_restart_fan_out_on_the_card_launches_the_kernels_on_every_rank(cuda, devices):
    """The MMCTM restart fan-out: one NCCL rank, or two ranks sharing the
    card over gloo. Each rank launches the η kernel once and the θ kernel
    twice per CAVI iteration (20, tol 0), and the lanes agree with the
    one-process fit of the same inits on the card."""
    from multimodalmusig_tpu_torch.parallel import sharding

    X = _poisson_docs()
    config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24)
    info = {}
    got = sharding.shmap_fit_restarts(3, X, config, [0.1, 0.1], restarts=6, maxiter=20, tol=0.0,
                                      devices=devices, run_info=info)
    want = mt.fit_restarts(3, X, config, [0.1, 0.1], restarts=6, maxiter=20, tol=0.0)
    assert info["backend"] == ("nccl" if len(devices) == 1 else "gloo")
    assert _launch_counts(info) == [(20, 0, 40)] * len(devices)
    assert got.ll.device.type == "cuda"
    torch.testing.assert_close(got.ll_history, want.ll_history, rtol=1e-4, atol=0.0)


def test_data_parallel_fit_on_the_card_launches_the_kernels_on_every_rank(cuda):
    """Two ranks sharing the card, 12 documents each, 20 iterations (tol 0):
    one η and two θ launches per iteration on each rank, the lls within
    f32 rounding of the one-process fit from the same init."""
    from multimodalmusig_tpu_torch.parallel import sharding

    X = _poisson_docs()
    config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24)
    from multimodalmusig_tpu_torch.models import mmctm as mm

    Xt = mm.counts_tensors(X, config, cuda)
    state = mm.init_with_alpha(torch.Generator().manual_seed(4), config, Xt, [0.1, 0.1],
                               device=cuda)
    info = {}
    got = sharding.sharded_data_parallel_fit(sharding.make_mesh(1, 2, ["cuda:0", "cuda:0"]),
                                             state, X, config, maxiter=20, tol=0.0,
                                             run_info=info)
    want = mm.fit(state, Xt, config, maxiter=20, tol=0.0)
    assert info["backend"] == "gloo" and _launch_counts(info) == [(20, 0, 40)] * 2
    torch.testing.assert_close(got.ll_history, want.ll_history, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.elbo, want.elbo, rtol=1e-4, atol=0.0)


@pytest.fixture
def cards(cuda):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more: one NCCL rank per card")
    return [f"cuda:{i}" for i in range(n)]


def test_multi_card_paths_over_nccl_match_the_one_process_fits(cuda, cards):
    """One rank per card over NCCL: the restart fan-out (7 lanes, padded),
    the data-parallel fit (the documents split over every card) and, on an
    even number of cards, a (2, n/2) mesh, each against the one-process fit
    of the same inits on the first card; one η and two θ launches per CAVI
    iteration (20, tol 0) on every rank."""
    from multimodalmusig_tpu_torch.models import mmctm as mm
    from multimodalmusig_tpu_torch.parallel import sharding

    X = _poisson_docs()
    config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24)
    kw = dict(restarts=7, maxiter=20, tol=0.0)
    want = mt.fit_restarts(3, X, config, [0.1, 0.1], **kw)
    info = {}
    got = sharding.shmap_fit_restarts(3, X, config, [0.1, 0.1], devices=cards, run_info=info,
                                      **kw)
    assert info["backend"] == "nccl" and _launch_counts(info) == [(20, 0, 40)] * len(cards)
    torch.testing.assert_close(got.ll_history, want.ll_history, rtol=1e-4, atol=0.0)

    Xt = mm.counts_tensors(X, config, cuda)
    state = mm.init_with_alpha(torch.Generator().manual_seed(4), config, Xt, [0.1, 0.1],
                               device=cuda)
    info = {}
    got = sharding.sharded_data_parallel_fit(sharding.make_mesh(1, len(cards), cards), state, X,
                                             config, maxiter=20, tol=0.0, run_info=info)
    single = mm.fit(state, Xt, config, maxiter=20, tol=0.0)
    assert info["backend"] == "nccl" and _launch_counts(info) == [(20, 0, 40)] * len(cards)
    torch.testing.assert_close(got.ll_history, single.ll_history, rtol=1e-4, atol=0.0)

    if len(cards) % 2 == 0 and len(cards) >= 4:
        mesh = sharding.make_mesh(2, len(cards) // 2, cards)
        got = sharding.sharded_fit_restarts(mesh, 3, X, config, [0.1, 0.1], **kw)
        torch.testing.assert_close(got.ll_history, want.ll_history, rtol=1e-4, atol=0.0)


def test_vocab_fit_on_the_card_launches_the_kernels_on_every_rank(cuda):
    """The vocab-sharded fit on two ranks sharing the card (gloo), V = (10,
    8) split (5, 4) a rank: one η launch on all documents and two θ launches
    on the rank's columns per CAVI iteration (20, tol 0), the replicated
    state the same on both ranks (the join checks it), and the lls against
    the one-process fit of the same init on the card."""
    from multimodalmusig_tpu_torch.models import mmctm as mm
    from multimodalmusig_tpu_torch.parallel import sharding

    X = _poisson_docs()
    config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24)
    Xt = mm.counts_tensors(X, config, cuda)
    state = mm.init_with_alpha(torch.Generator().manual_seed(4), config, Xt, [0.1, 0.1],
                               device=cuda)
    info = {}
    got = sharding.sharded_vocab_parallel_fit(["cuda:0", "cuda:0"], state, X, config,
                                              maxiter=20, tol=0.0, run_info=info)
    want = mm.fit(state, Xt, config, maxiter=20, tol=0.0)
    assert info["backend"] == "gloo" and _launch_counts(info) == [(20, 0, 40)] * 2
    assert got.state.gamma[0].shape == want.state.gamma[0].shape
    torch.testing.assert_close(got.ll_history, want.ll_history, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.elbo, want.elbo, rtol=1e-4, atol=0.0)


def test_multi_card_vocab_fit_over_nccl_matches_the_one_card_fit(cuda, cards):
    """The vocab-sharded fit with one rank per card over NCCL, V = (10, 8)
    split over every card: one η and two θ launches per CAVI iteration (20,
    tol 0) on every rank, and the lls against the one-card fit of the same
    init."""
    from multimodalmusig_tpu_torch.models import mmctm as mm
    from multimodalmusig_tpu_torch.parallel import sharding

    X = _poisson_docs()
    config = mt.MMCTMConfig(K=(2, 2), V=(10, 8), D=24)
    Xt = mm.counts_tensors(X, config, cuda)
    state = mm.init_with_alpha(torch.Generator().manual_seed(4), config, Xt, [0.1, 0.1],
                               device=cuda)
    info = {}
    got = sharding.sharded_vocab_parallel_fit(cards, state, X, config, maxiter=20, tol=0.0,
                                              run_info=info)
    single = mm.fit(state, Xt, config, maxiter=20, tol=0.0)
    assert info["backend"] == "nccl" and _launch_counts(info) == [(20, 0, 40)] * len(cards)
    torch.testing.assert_close(got.ll_history, single.ll_history, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.elbo, single.elbo, rtol=1e-4, atol=0.0)


# ---------------------------------------------------------------------------
# The λ solve's options: the η kernel's secant start (lambda_extrap) and the
# direct Cholesky direction (lambda_solver="chol")
# ---------------------------------------------------------------------------


def _extrap_problem(seed, R, D, K, swing, device):
    """`_eta_problem` and a previous λ at a distance of about `swing` (at 8
    the ±4 clip binds on about 60% of the entries)."""
    args = _eta_problem(seed, R, D, K, device)
    rng = np.random.default_rng(seed + 1)
    lam_prev = args[0] - torch.as_tensor(swing * rng.standard_normal(tuple(args[0].shape)),
                                         dtype=torch.float32, device=device)
    return args, lam_prev


@pytest.mark.parametrize("R, D, K, budgets", [
    (100, 560, (7, 7), CAVI),  # MK 14: the thread layout
    (100, 560, (10, 9), CAVI),  # MK 19: the pair layout
    (3, 70, (20, 20), {}),  # MK 40 at few problems: the block layout
    (30, 557, (20, 20), CAVI),  # MK 40: split4
    (30, 557, (64, 64), CAVI),  # MK 128: split8
    (1, 560, (7, 7), CAVI),  # R = 1: the warp layout
])
@pytest.mark.parametrize("swing", [0.3, 8.0])
def test_eta_kernel_with_lam_prev_matches_plain(cuda, R, D, K, budgets, swing):
    """The secant start formed in the kernel, on every layout: the
    tolerances of test_eta_kernel_matches_plain, and repeats bit-identical."""
    args, lam_prev = _extrap_problem(R * D + sum(K), R, D, K, swing, cuda)
    kw = dict(budgets, lam_prev=lam_prev, extrap=1.0)
    before = ek.LAUNCHES
    got = ek.estep_eta_fused(*args, K, **kw)
    again = ek.estep_eta_fused(*args, K, **kw)
    want = ek.estep_eta_fused_plain(*args, K, **kw)
    torch.cuda.synchronize()
    assert ek.LAUNCHES == before + 2
    assert all(torch.isfinite(g).all() for g in got)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6)
    assert float((got[2] - want[2]).abs().max()) <= ATOL
    # the start moved the solve: λ differs from the run without it
    assert not torch.equal(got[2], ek.estep_eta_fused(*args, K, **budgets)[2])


@pytest.mark.parametrize("K", [(7, 7), (10, 9), (20, 20)])
def test_eta_kernel_without_lam_prev_is_the_call_without_it(cuda, K):
    """lam_prev=None, or a coefficient of 0, runs the kernel exactly as the
    call without them; repeats bit-identical."""
    args, lam_prev = _extrap_problem(17, 3, 70, K, 2.0, cuda)
    base = ek.estep_eta_fused(*args, K, **CAVI)
    for kw in (dict(lam_prev=None, extrap=1.0), dict(lam_prev=lam_prev, extrap=0.0),
               dict(lam_prev=lam_prev, extrap=None), {}):
        got = ek.estep_eta_fused(*args, K, **CAVI, **kw)
        assert all(torch.equal(g, b) for g, b in zip(got, base))


@pytest.mark.parametrize("R, D, K, budgets", [
    (100, 448, (9, 9), CAVI),
    (3, 70, (7, 7, 5), {}),
    (3, 37, (11, 10), {}),
    (3, 50, (16, 16), {}),
    (1, 112, (7, 7), CAVI),
    (3, 70, (20, 20), {}),  # split4 and block
    (2, 41, (64, 64), {}),  # split8 and block
])
def test_eta_kernel_with_lam_prev_on_every_layout(cuda, R, D, K, budgets):
    """The secant start on each launch of _candidate_geometries, with the ±4
    clip binding on most entries: the tolerances of
    test_eta_kernel_matches_plain, repeats bit-identical, and with
    lam_prev=None the bits of the call without it."""
    args, lam_prev = _extrap_problem(R * D + 3 * sum(K), R, D, K, 8.0, cuda)
    kw = dict(budgets, lam_prev=lam_prev, extrap=1.0)
    want = ek.estep_eta_fused_plain(*args, K, **kw)
    for geo in ek._candidate_geometries(sum(K)):
        got = ek._launch_at(geo, *args, K, **kw)
        again = ek._launch_at(geo, *args, K, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, a) for g, a in zip(got, again)), geo
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-6, msg=lambda m: f"{geo}: {m}")
        assert float((got[2] - want[2]).abs().max()) <= ATOL, geo
        base = ek._launch_at(geo, *args, K, **budgets)
        none = ek._launch_at(geo, *args, K, **budgets, lam_prev=None, extrap=1.0)
        assert all(torch.equal(g, b) for g, b in zip(none, base)), geo
        assert not torch.equal(got[2], base[2]), geo


def _digest_problem(seed, R, D, K):
    """The inputs of the digests below, from a torch generator on the CPU."""
    g = torch.Generator().manual_seed(seed)
    MK = sum(K)
    A = torch.randn(R, MK, MK, generator=g, dtype=torch.float64)
    invS = (torch.eye(MK, dtype=torch.float64) + 0.05 * A @ A.mT / MK).float()
    lam = 0.5 * torch.randn(R, D, MK, generator=g)
    nu = 0.5 + torch.rand(R, D, MK, generator=g)
    N = torch.randint(0, 200, (D, len(K)), generator=g).float()
    st = 5 * torch.rand(R, D, MK, generator=g)
    mu = torch.randn(R, MK, generator=g)
    return [t.cuda() for t in (lam, nu, N, st, mu, invS)]


# sha256 (first 16 hex digits) of the η kernel's outputs (ζ, ν, λ bytes)
# without lam_prev (NVIDIA H100 80GB HBM3, nvcc 12.9), on
# `_digest_problem(seed, R, D, K)`, in the layout `launch_geometry` picks:
# (seed, R, D, K, budgets) -> digest. Keys whose layout is the one the
# kernel had before it took lam_prev keep that kernel's bits (the thread
# layout at 100, 101 and 103, the warp at 105, the block at 106 and 108);
# 102, 109 and 110 now take the warp layout, 104 the pair and 107 split4,
# pinned from it; 111–116 pin split4 at P = 10, 12, 16 and split8 at P =
# 10, 12, 16.
ETA_DIGESTS = {
    (100, 100, 560, (7, 7), "cavi"): "d43dd87f2ca3ac30",
    (101, 100, 560, (7, 7), "cold"): "d9e29a5aca0fc757",
    (102, 1, 560, (7, 7), "cavi"): "e8a395857eecf7d3",
    (103, 100, 560, (8, 8), "cavi"): "940a7f103ba64b04",
    (104, 100, 560, (9, 8), "cavi"): "bd3d687132ecab93",
    (105, 3, 50, (16, 16), "cold"): "44715636e2d5c74c",
    (106, 3, 50, (17, 16), "cold"): "4c262521f3098e07",
    (107, 100, 560, (20, 20), "cavi"): "96b41dec7c3368e0",
    (108, 3, 29, (40, 50, 38), "cold"): "336de164f56b75e9",
    (109, 1, 9, (7, 7), "cold"): "b93f82baa54b3c09",
    (110, 3, 37, (3, 4, 5), "cold"): "83e7bcfe41f750f4",
    (111, 30, 557, (17, 16), "cavi"): "ea3f90ff2b537e1a",
    (112, 30, 557, (24, 24), "cavi"): "8ff071ff2a1c43a6",
    (113, 30, 557, (29, 28), "cavi"): "5f07d618e83a83c7",
    (114, 30, 557, (33, 32), "cavi"): "35b27d94c3862859",
    (115, 30, 557, (48, 48), "cavi"): "06108bae7ed9ac55",
    (116, 30, 557, (64, 64), "cavi"): "47a968175f045d75",
}
# The five re-pinned keys launched in the layout they had before: the
# digests of the kernel before it took lam_prev (107: before split4).
OLD_LAYOUT_DIGESTS = {
    (102, 1, 560, (7, 7), "cavi", ("thread", 14, 64)): "4e4316f15342c2e0",
    (104, 100, 560, (9, 8), "cavi", ("warp", 32, 8)): "a18470b3f3259ff9",
    (109, 1, 9, (7, 7), "cold", ("thread", 14, 64)): "eeae18d7d82cd7bf",
    (110, 3, 37, (3, 4, 5), "cold", ("thread", 12, 64)): "d762e4cdb7c2ead8",
    (107, 100, 560, (20, 20), "cavi", ("block", 64, 4)): "7a1ffe90ce3fb897",
}


def _digest(out):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in out)).hexdigest()[:16]


@pytest.mark.parametrize("key", sorted(ETA_DIGESTS))
def test_eta_kernel_without_lam_prev_keeps_the_bits_it_had_before(cuda, key):
    seed, R, D, K, budgets = key
    out = ek.estep_eta_fused(*_digest_problem(seed, R, D, K), K,
                             **(CAVI if budgets == "cavi" else {}))
    assert _digest(out) == ETA_DIGESTS[key]


@pytest.mark.parametrize("key", sorted(OLD_LAYOUT_DIGESTS))
def test_eta_kernel_keeps_the_old_bits_on_the_old_layouts(cuda, key):
    seed, R, D, K, budgets, geo = key
    assert tuple(ek.launch_geometry(R, D, sum(K))) != geo
    out = ek._launch_at(geo, *_digest_problem(seed, R, D, K), K,
                        **(CAVI if budgets == "cavi" else {}))
    assert _digest(out) == OLD_LAYOUT_DIGESTS[key]


def test_solve_eta_forms_the_secant_start_in_the_eta_kernel(cuda):
    """A float32 config with lambda_extrap: one η launch, no λ launch, the
    bits of the wrapper called with lam_prev."""
    K = (7, 7)
    args, lam_prev = _extrap_problem(21, 2, 40, K, 3.0, cuda)
    config = mt.MMCTMConfig(K=K, V=(96, 48), D=40, dtype=torch.float32, lambda_extrap=1.0)
    eta, lam = ek.LAUNCHES, lk.LAUNCHES
    got = ctm_base.solve_eta(*args, config, lam_prev=lam_prev)
    assert (ek.LAUNCHES, lk.LAUNCHES) == (eta + 1, lam)
    want = ek.estep_eta_fused(*args, K, **CAVI, lam_prev=lam_prev, extrap=1.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_chol_fit_on_the_card_launches_neither_the_eta_nor_the_lambda_kernel(cuda):
    """lambda_solver="chol" on the card: the split η route and the plain λ
    solver, as in the JAX package; θ still takes its kernel. 2 lanes x 10
    iterations of BRCA-EU against the same fit in float64 on the CPU."""
    X = [mt.read_counts_tsv(mt.brca_counts_path(f))[0].T
         for f in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")]
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, lambda_n_iter=3,
                                lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4,
                                lambda_solver="chol")
        before = (ek.LAUNCHES, lk.LAUNCHES, tk.LAUNCHES)
        res = mt.fit_restarts(0, X, config, [0.1, 0.1], restarts=2, maxiter=10, tol=0.0,
                              device=device)
        if device == cuda:
            assert (ek.LAUNCHES, lk.LAUNCHES, tk.LAUNCHES) == (before[0], before[1],
                                                              before[2] + 20)
        out.append(res.ll_history.cpu().double().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4)


def test_extrap_fit_on_the_card_matches_the_cpu_in_float64(cuda):
    """test_fit_on_the_card_matches_the_cpu_in_float64 with lambda_extrap =
    1.0: the η kernel once per iteration, the secant start in it."""
    X = [mt.read_counts_tsv(mt.brca_counts_path(f))[0].T
         for f in ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")]
    out = []
    for dtype, device in ((torch.float32, cuda), (torch.float64, "cpu")):
        config = mt.MMCTMConfig(K=(7, 7), V=(96, 48), D=560, dtype=dtype, lambda_n_iter=3,
                                lambda_cg_iter=4, lambda_polish_iter=1, nu_n_iter=4)
        config = dataclasses.replace(config, lambda_extrap=1.0)
        before = ek.LAUNCHES
        res = mt.fit_restarts(0, X, config, [0.1, 0.1], restarts=2, maxiter=10, tol=0.0,
                              device=device)
        if device == cuda:
            assert ek.LAUNCHES - before == 10
        out.append(res.ll_history.cpu().double().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4)
