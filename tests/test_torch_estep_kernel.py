"""The fused η side of the E-step in the PyTorch port: the plain version
against the JAX package's Pallas kernel (interpret mode on the CPU) and
against the JAX XLA sequence in float64, the split route against the plain
version, and the dispatch rule. The CUDA kernel itself is held against the
plain version on a card by tests/test_torch_cuda.py.

Tolerances: float32, rtol 2e-5 and atol 2e-6, the JAX suite's own bound
between its Pallas η kernel and the XLA sequence
(tests/test_pallas_kernels.py:172-174); float64, rtol 1e-10, the
trajectory standard of the port's other f64 parity tests."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.ops import estep_kernel as ek

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"),
)

torch.set_num_threads(2)

RTOL32, ATOL32 = 2e-5, 2e-6


def _inputs(rng, R, B, K, dtype=np.float32):
    """The inputs of tests/test_pallas_kernels.py TestFusedEstep, with a
    leading restart dimension and one μ/Σ⁻¹ per lane."""
    MK, M = sum(K), len(K)
    lam = rng.standard_normal((R, B, MK))
    nu = rng.uniform(0.05, 1.0, (R, B, MK))
    N = rng.integers(0, 40, (B, M)).astype(np.float64)
    st = rng.uniform(0.0, 10.0, (R, B, MK))
    mu = rng.standard_normal((R, MK))
    A = rng.standard_normal((R, MK, MK))
    invS = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(MK)
    return [a.astype(dtype) for a in (lam, nu, N, st, mu, invS)]


@pytest.mark.parametrize("R, B, K", [
    (1, 17, (3, 4)), (3, 17, (3, 4)), (2, 9, (2, 3, 2)),
    (1, 7, (9, 9)), (3, 7, (9, 9)),  # K selection's MK 18
    (1, 6, (7, 7, 5)), (3, 6, (7, 7, 5)),  # PCAWG's K
])
def test_plain_matches_the_jax_kernel_per_lane(rng, R, B, K):
    from pallas_experiments.estep_kernel import estep_eta_fused as jax_fused

    lam, nu, N, st, mu, invS = _inputs(rng, R, B, K)
    got = ek.estep_eta_fused_plain(*map(torch.as_tensor, (lam, nu, N, st, mu, invS)), K)
    assert [tuple(g.shape) for g in got] == [(R, B, len(K)), (R, B, sum(K)), (R, B, sum(K))]
    for r in range(R):
        want = jax_fused(jnp.asarray(lam[r]), jnp.asarray(nu[r]), jnp.asarray(N),
                         jnp.asarray(st[r]), jnp.asarray(mu[r]), jnp.asarray(invS[r]), K,
                         tile_b=128, interpret=True)
        for g, w, label in zip(got, want, ("zeta", "nu", "lam")):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), rtol=RTOL32, atol=ATOL32,
                                       err_msg=label)


# the JAX suite's bound between its Pallas λ kernel and its jnp solver
# (tests/test_pallas_kernels.py:131), the card tests' bound for λ
LAM_ATOL32 = 5e-5


@pytest.mark.parametrize("R, B, K", [
    (1, 5, (20, 20)), (2, 5, (20, 20)),  # MK 40: split4 on the card
    (1, 3, (40, 50, 38)), (2, 3, (40, 50, 38)),  # MK 128: split8
])
def test_plain_matches_the_jax_kernel_per_lane_above_MK_32(rng, R, B, K):
    """As test_plain_matches_the_jax_kernel_per_lane, ζ and ν at the same
    tolerance. λ at LAM_ATOL32: over 40 to 128 coordinates the float32
    rounding of the 7 Newton steps of 10 PCG iterations moves λ by about
    1e-5 on either side, both as far from the float64 solve (at (1, 5,
    (20, 20)): the port 2.2e-5, the JAX kernel 1.1e-5); the float64 test
    below holds the plain version against the JAX package's XLA sequence at
    1e-10 at MK 40."""
    from pallas_experiments.estep_kernel import estep_eta_fused as jax_fused

    lam, nu, N, st, mu, invS = _inputs(rng, R, B, K)
    got = ek.estep_eta_fused_plain(*map(torch.as_tensor, (lam, nu, N, st, mu, invS)), K)
    for r in range(R):
        want = jax_fused(jnp.asarray(lam[r]), jnp.asarray(nu[r]), jnp.asarray(N),
                         jnp.asarray(st[r]), jnp.asarray(mu[r]), jnp.asarray(invS[r]), K,
                         tile_b=128, interpret=True)
        for g, w, label in zip(got[:2], want[:2], ("zeta", "nu")):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), rtol=RTOL32, atol=ATOL32,
                                       err_msg=label)
        np.testing.assert_allclose(got[2][r].numpy(), np.asarray(want[2]), rtol=0,
                                   atol=LAM_ATOL32, err_msg="lam")


def _matches_the_jax_xla_sequence_in_float64(rng, K, R, B):
    from multimodalmusig_tpu.models.ctm_base import (
        CTMBaseConfig,
        calculate_Ndivzeta,
        update_zeta,
    )
    from multimodalmusig_tpu.ops.solvers import maximize_lambda, maximize_nu

    MK = sum(K)
    lam, nu, N, st, mu, invS = _inputs(rng, R, B, K, dtype=np.float64)
    budgets = dict(n_iter=7, cg_iter=MK, polish_iter=2)
    got = ek.estep_eta_fused_plain(*map(torch.as_tensor, (lam, nu, N, st, mu, invS)), K,
                                   nu_n_iter=8, **budgets)
    config = CTMBaseConfig(K=K, V=(5, 5), D=B, dtype=jnp.float64)
    for r in range(R):
        zeta = update_zeta(jnp.asarray(lam[r]), jnp.asarray(nu[r]), config)
        ndz = calculate_Ndivzeta(jnp.asarray(N), zeta, config)
        nu2 = maximize_nu(jnp.asarray(nu[r]), jnp.asarray(lam[r]), ndz,
                          jnp.diagonal(jnp.asarray(invS[r]))[None, :], n_iter=8)
        lam2 = maximize_lambda(jnp.asarray(lam[r]), nu2, ndz, jnp.asarray(st[r]),
                               jnp.asarray(mu[r]), jnp.asarray(invS[r]), **budgets)
        for g, w, label in zip(got, (zeta, nu2, lam2), ("zeta", "nu", "lam")):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), rtol=1e-10, err_msg=label)


def test_plain_matches_the_jax_xla_sequence_in_float64(rng):
    """ζ → N/ζ → ν → λ of the JAX package (update_zeta, calculate_Ndivzeta,
    maximize_nu, maximize_lambda) per lane, at the same budgets."""
    _matches_the_jax_xla_sequence_in_float64(rng, (3, 4), 3, 17)


def test_plain_matches_the_jax_xla_sequence_in_float64_at_MK_40(rng):
    """The same at K = (20, 20), split4's range on the card."""
    _matches_the_jax_xla_sequence_in_float64(rng, (20, 20), 2, 5)


def test_zero_count_modality(rng):
    """A document with zero counts in one modality: N/ζ = 0 there, and the
    ν and λ solves stay finite (the 0·exp guard), as in the JAX kernel."""
    from pallas_experiments.estep_kernel import estep_eta_fused as jax_fused

    K, B = (2, 2), 5
    lam = np.zeros((1, B, 4), np.float32)
    nu = np.ones((1, B, 4), np.float32)
    N = rng.integers(0, 30, (B, 2)).astype(np.float32)
    N[0, 1] = 0.0
    st = rng.uniform(0.0, 5.0, (1, B, 4)).astype(np.float32)
    st[0, 0, 2:] = 0.0
    mu = np.zeros((1, 4), np.float32)
    invS = np.eye(4, dtype=np.float32)[None]
    got = ek.estep_eta_fused(*map(torch.as_tensor, (lam, nu, N, st, mu, invS)), K)
    assert all(torch.isfinite(g).all() for g in got)
    want = jax_fused(*(jnp.asarray(a[0]) for a in (lam, nu)), jnp.asarray(N),
                     jnp.asarray(st[0]), jnp.asarray(mu[0]), jnp.asarray(invS[0]), K,
                     tile_b=128, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=RTOL32, atol=ATOL32)


def test_split_route_computes_what_the_plain_version_computes(rng):
    """On the CPU solve_eta takes the "split" route; at the resolved CAVI
    budgets it is the kernel's plain version, bit for bit."""
    K = (3, 4)
    lam, nu, N, st, mu, invS = map(torch.as_tensor, _inputs(rng, 2, 11, K))
    config = ctm_base.CTMBaseConfig(K=K, V=(5, 5), D=11, dtype=torch.float32)
    got = ctm_base.solve_eta(lam, nu, N, st, mu, invS, config)
    b = ctm_base.resolved_budgets(config)
    want = ek.estep_eta_fused_plain(lam, nu, N, st, mu, invS, K, n_iter=b["lambda_n_iter"],
                                    cg_iter=b["lambda_cg_iter"],
                                    polish_iter=b["lambda_polish_iter"],
                                    nu_n_iter=b["nu_n_iter"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_fused_route_hands_the_kernel_the_resolved_budgets(rng, monkeypatch):
    """With the route forced to "fused", solve_eta calls the η kernel's
    wrapper once with the config's K and budgets (on the CPU the wrapper
    then takes the plain version, so the result equals the split route's)."""
    calls = []
    real = ek.estep_eta_fused

    def spy(*a, **k):
        calls.append((a[6], k))
        return real(*a, **k)

    K = (2, 3)
    lam, nu, N, st, mu, invS = map(torch.as_tensor, _inputs(rng, 2, 6, K))
    config = ctm_base.CTMBaseConfig(K=K, V=(5, 5), D=6, dtype=torch.float32, nu_n_iter=6)
    split = ctm_base.solve_eta(lam, nu, N, st, mu, invS, config)
    monkeypatch.setattr(ek, "estep_eta_fused", spy)
    monkeypatch.setattr(ctm_base, "_eta_route", lambda *a: "fused")
    fused = ctm_base.solve_eta(lam, nu, N, st, mu, invS, config)
    assert calls == [(K, dict(n_iter=3, cg_iter=4, polish_iter=1, nu_n_iter=6))]
    assert all(torch.equal(a, b) for a, b in zip(fused, split))


@pytest.mark.parametrize("device, dtype, MK, route", [
    ("cuda", torch.float32, 14, "fused"),
    ("cuda", torch.float32, 40, "fused"),
    ("cuda", torch.float32, 128, "fused"),
    ("cuda", torch.float32, 129, "split"),
    ("cuda", torch.float64, 14, "split"),
    ("cpu", torch.float32, 14, "split"),
    ("cpu", torch.float64, 40, "split"),
])
def test_eta_route(device, dtype, MK, route):
    assert ctm_base._eta_route(device, dtype, MK) == route


def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    args = list(map(torch.as_tensor, _inputs(rng, 2, 7, (2, 2))))
    before = ek.LAUNCHES
    got = ek.estep_eta_fused(*args, (2, 2), n_iter=2, cg_iter=3, polish_iter=1, nu_n_iter=3)
    want = ek.estep_eta_fused_plain(*args, (2, 2), n_iter=2, cg_iter=3, polish_iter=1,
                                    nu_n_iter=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ek.LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take(rng):
    args = list(map(torch.as_tensor, _inputs(rng, 1, 4, (2, 3))))
    with pytest.raises(ValueError, match="summing to MK"):
        ek.estep_eta_fused(*args, (2, 2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ek.estep_eta_fused(*(a.to("meta") for a in args), (2, 3))
    big = [torch.zeros(1, 2, 129), torch.ones(1, 2, 129), torch.ones(2, 1),
           torch.zeros(1, 2, 129), torch.zeros(1, 129), torch.eye(129)[None]]
    with pytest.raises(ValueError, match="exceeds the η kernel's limit"):
        ek.estep_eta_fused(*big, (129,))


@pytest.mark.parametrize("R, D, MK, layout, P, docs", [
    # restart batches: one thread to MK 16, the pair to 28, then one thread
    (100, 560, 14, "thread", 14, 64),  # the BRCA main path, K = (7, 7)
    (1000, 560, 14, "thread", 14, 64),
    (100, 560, 13, "thread", 14, 64),
    (100, 448, 10, "thread", 10, 64),  # K selection's (5, 5)
    (100, 560, 1, "thread", 2, 64),
    (100, 560, 16, "thread", 16, 64),
    (100, 560, 17, "pair", 10, 64),
    (100, 448, 18, "pair", 10, 64),  # K selection's (9, 9)
    (100, 560, 19, "pair", 10, 64),
    (100, 2800, 19, "pair", 10, 64),  # PCAWG's (7, 7, 5)
    (1000, 2800, 19, "pair", 10, 64),
    (100, 560, 20, "pair", 10, 64),
    (100, 560, 21, "pair", 12, 64),
    (100, 560, 25, "pair", 14, 64),
    (100, 560, 28, "pair", 14, 64),
    (100, 560, 29, "thread", 32, 64),
    (100, 560, 32, "thread", 32, 64),
    (1, 50688, 29, "pair", 16, 64),  # the pair at P = 16 to its third wave
    (1, 50689, 29, "thread", 32, 64),
    (90, 560, 32, "pair", 16, 64),
    # above MK 32: 4 threads a problem to MK 64, 8 beyond, each at its least P
    (100, 560, 33, "split4", 10, 32),
    (100, 560, 40, "split4", 10, 32),  # K = (20, 20): stage 1 of the two-stage fit
    (1000, 560, 40, "split4", 10, 32),
    (100, 2800, 40, "split4", 10, 32),  # K = (20, 12, 8)
    (100, 560, 41, "split4", 12, 32),
    (100, 560, 48, "split4", 12, 32),
    (100, 560, 49, "split4", 14, 32),
    (100, 560, 57, "split4", 16, 32),
    (100, 560, 64, "split4", 16, 32),
    (100, 560, 65, "split8", 10, 16),
    (100, 560, 80, "split8", 10, 16),
    (100, 560, 81, "split8", 12, 16),
    (100, 560, 97, "split8", 14, 16),
    (100, 560, 113, "split8", 16, 16),
    (100, 560, 128, "split8", 16, 16),
    # few problems above MK 32: the block layout
    (1, 9, 128, "block", 128, 2),
    (1, 560, 40, "block", 64, 4),  # K = (20, 20): stage 2, MMCTM.fit
    (1, 112, 40, "block", 64, 4),
    (1, 448, 40, "block", 64, 4),
    (1, 2800, 40, "split4", 10, 32),
    (1, 560, 64, "block", 64, 4),
    (1, 448, 65, "block", 128, 2),
    (1, 560, 65, "split8", 10, 16),
    (1, 560, 128, "block", 128, 2),
    (1, 2800, 128, "split8", 16, 16),
    (32, 560, 128, "split8", 16, 16),
    # calls of few problems: R = 1 (stage 2, MMCTM.fit, inference, ranks)
    (1, 560, 14, "warp", 16, 4),
    (1, 448, 14, "warp", 16, 4),
    (1, 112, 14, "warp", 16, 4),
    (1, 280, 14, "warp", 16, 4),
    (1, 2800, 14, "warp", 16, 4),
    (1, 9, 14, "warp", 16, 4),
    (1, 112, 10, "warp", 16, 4),
    (1, 112, 18, "warp", 32, 8),
    (1, 2800, 19, "warp", 32, 8),
    # either side of each few-problem crossover
    (1, 2599, 4, "warp", 16, 4), (1, 2600, 4, "thread", 4, 64),
    (1, 6499, 10, "warp", 16, 4), (1, 6500, 10, "thread", 10, 64),
    (1, 9099, 14, "warp", 16, 4), (1, 9100, 14, "thread", 14, 64),
    (16, 560, 14, "warp", 16, 4), (18, 560, 14, "thread", 14, 64),
    (1, 10399, 15, "warp", 16, 4), (1, 10400, 15, "thread", 16, 64),
    (1, 20479, 16, "warp", 16, 4), (1, 20480, 16, "thread", 16, 64),
    (1, 3167, 17, "warp", 32, 8), (1, 3168, 17, "pair", 10, 64),
    (1, 3167, 24, "warp", 32, 8), (1, 3168, 24, "pair", 12, 64),
    (1, 4351, 25, "warp", 32, 8), (1, 4352, 25, "pair", 14, 64),
    (1, 6143, 31, "warp", 32, 8), (1, 6144, 31, "pair", 16, 64),
    (1, 10239, 32, "warp", 32, 8), (1, 10240, 32, "pair", 16, 64),
    (1, 999, 33, "block", 64, 4), (1, 1000, 33, "split4", 10, 32),
    (1, 999, 40, "block", 64, 4), (1, 1000, 40, "split4", 10, 32),
    (1, 1499, 48, "block", 64, 4), (1, 1500, 48, "split4", 12, 32),
    (1, 1999, 56, "block", 64, 4), (1, 2000, 56, "split4", 14, 32),
    (1, 2999, 64, "block", 64, 4), (1, 3000, 64, "split4", 16, 32),
    (1, 499, 65, "block", 128, 2), (1, 500, 65, "split8", 10, 16),
    (1, 699, 96, "block", 128, 2), (1, 700, 96, "split8", 12, 16),
    (1, 999, 112, "block", 128, 2), (1, 1000, 112, "split8", 14, 16),
    (1, 1499, 128, "block", 128, 2), (1, 1500, 128, "split8", 16, 16),
    (4, 560, 128, "split8", 16, 16), (6, 560, 64, "split4", 16, 32), (5, 560, 64, "block", 64, 4),
])
def test_launch_geometry_picks_the_layout_by_MK(R, D, MK, layout, P, docs):
    geo = ek.launch_geometry(R, D, MK)
    assert (geo.layout, geo.P, geo.docs_per_block) == (layout, P, docs)
    ek._check_geometry(geo, MK)  # a launch the kernel takes
    assert geo in ek._candidate_geometries(MK)
    threads = {"pair": 2, "split4": 4, "split8": 8}.get(layout, 1)  # a problem's
    assert threads * geo.P >= MK
    if layout == "block":  # blocks of 256 threads, P a problem
        assert geo.docs_per_block * geo.P == 256
    if layout == "warp":  # whole warps of 16- or 32-lane groups
        assert geo.docs_per_block * geo.P % 32 == 0
    if layout in ("split4", "split8"):  # blocks of 128 threads
        assert geo.docs_per_block * threads == 128


@pytest.mark.parametrize("R, D, MK, blocks", [
    (100, 560, 14, 9),  # 560 of 576 threads live
    (100, 561, 14, 9),
    (1000, 37, 14, 1),
    (1000, 65, 14, 2),
    (1000, 64, 14, 1),
    (10000, 1, 14, 1),
    (100, 448, 19, 7),  # the pair: 64 documents, 128 threads
    (100, 2800, 19, 44),  # PCAWG
    (1, 9, 14, 3),  # R = 1: the warp group, 4 documents a block
    (1, 112, 14, 28),
    (1, 280, 14, 70),
    (1, 560, 14, 140),
    (1, 2800, 14, 700),
    (1, 2800, 19, 350),  # 8 documents of 32 lanes
    (3, 50, 40, 13),  # the block group, 4 documents
    (100, 560, 40, 18),  # split4: 32 documents of 4 threads
    (100, 2800, 40, 88),
    (100, 560, 128, 35),  # split8: 16 documents of 8 threads
    (1, 2800, 128, 175),
])
def test_thread_layout_blocks_cover_every_document_once(R, D, MK, blocks):
    """The kernel's grid is ⌈D / docs_per_block⌉ blocks per restart, so
    every document lies in exactly one block and no block is empty."""
    docs = ek.launch_geometry(R, D, MK).docs_per_block
    assert -(-D // docs) == blocks
    assert (blocks - 1) * docs < D <= blocks * docs


def test_every_candidate_is_a_launch_the_kernel_takes():
    """_candidate_geometries lists, for each MK, launches that
    _check_geometry (the kernel's own rules) accepts, the picked layout
    among them at every count; one thread and the pair stop where the
    kernel's instantiations do."""
    for MK in range(1, ek.KERNEL_MAX_MK + 1):
        cands = ek._candidate_geometries(MK)
        for geo in cands:
            ek._check_geometry(geo, MK)
        for n in (1, 560, 3168, 9100, 20480, 50689, 560_000):
            assert ek.launch_geometry(1, n, MK) in cands
    with pytest.raises(ValueError, match="no launch"):
        ek._check_geometry(ek.EtaGeometry("thread", 20, 64), 19)
    with pytest.raises(ValueError, match="no launch"):
        ek._check_geometry(ek.EtaGeometry("pair", 10, 20), 19)
    with pytest.raises(ValueError, match="no launch"):
        ek._check_geometry(ek.EtaGeometry("warp", 16, 4), 17)
    # split4 and split8: P one of 10, 12, 14, 16 with Split·P ≥ MK, whole
    # warps of problems, at most 128 threads a block
    for geo, MK in (("split4", 10, 32), 41), (("split4", 9, 32), 33), (("split4", 10, 36), 40), \
            (("split4", 10, 12), 40), (("split4", 10, 0), 40), (("split8", 16, 20), 128), \
            (("split8", 16, 6), 128), (("split8", 14, 16), 113), (("split2", 16, 16), 32), \
            (("split8", 18, 16), 128):
        with pytest.raises(ValueError, match="no launch"):
            ek._check_geometry(ek.EtaGeometry(*geo), MK)
    for geo, MK in (("split4", 10, 8), 40), (("split4", 16, 24), 64), (("split8", 16, 4), 128), \
            (("split8", 10, 12), 65), (("split8", 10, 16), 33):
        ek._check_geometry(ek.EtaGeometry(*geo), MK)


@pytest.mark.parametrize("R, D", [(0, 5), (2, 0)])
def test_launch_geometry_rejects_an_empty_call(R, D):
    with pytest.raises(ValueError, match="must be positive"):
        ek.launch_geometry(R, D, 14)


@pytest.mark.parametrize("MK", [0, 129])
def test_launch_geometry_rejects_MK_outside_the_kernel(MK):
    with pytest.raises(ValueError, match="outside the η kernel"):
        ek.launch_geometry(1, 560, MK)
