"""The fused θ moments of the PyTorch port: the plain version against the
JAX package's Pallas kernel (interpret mode on the CPU) and against the
port's factorized schedule, and the dispatch rules of both kernels. The CUDA
kernel itself is held against the plain version on a card by
tests/test_torch_cuda.py.

Tolerances: float32, rtol 2e-5 and atol 1e-4, the JAX suite's own bound
between its Pallas θ kernel and the einsums (tests/test_pallas_kernels.py:
221-222); float64, rtol 1e-12 between two exact schedules of the same
softmax."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu_torch.models import ctm_base
from multimodalmusig_tpu_torch.models.mmctm import MMCTMConfig
from multimodalmusig_tpu_torch.ops import theta_kernel as tk

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"),
)

torch.set_num_threads(2)


def _inputs(rng, R, D, V, K, dtype=np.float32):
    """Seeded inputs as in tests/test_pallas_kernels.py, per restart lane."""
    lam = rng.standard_normal((R, D, K)) * 2.0
    logw = rng.standard_normal((R, V, K)) - 4.0
    X = rng.integers(0, 30, (D, V)).astype(np.float64)
    return [a.astype(dtype) for a in (lam, logw, X)]


@pytest.mark.parametrize("D, V, K", [(17, 96, 7), (560, 48, 7), (33, 128, 11), (8, 5, 2),
                                     (21, 96, 20), (9, 48, 64)])
def test_plain_matches_jax_kernel_per_lane(rng, D, V, K):
    from pallas_experiments.theta_kernel import theta_moments_fused as jax_fused

    lam, logw, X = _inputs(rng, 2, D, V, K)
    st, sc = tk.theta_moments_fused_plain(*map(torch.as_tensor, (lam, logw, X)))
    assert st.shape == (2, D, K) and sc.shape == (2, K, V)
    for r in range(2):
        want_st, want_sc = jax_fused(jnp.asarray(lam[r]), jnp.asarray(logw[r]), jnp.asarray(X),
                                     tile_d=16, interpret=True)
        np.testing.assert_allclose(st[r].numpy(), np.asarray(want_st), rtol=2e-5, atol=1e-4)
        np.testing.assert_allclose(sc[r].numpy(), np.asarray(want_sc), rtol=2e-5, atol=1e-4)


def test_plain_matches_the_factorized_schedule_in_float64(rng):
    """Two modalities through ctm_base.theta_moments on the CPU (the
    factorized schedule) against the plain version per modality."""
    config = MMCTMConfig(K=(7, 3), V=(24, 9), D=13, dtype=torch.float64)
    lam = torch.as_tensor(rng.standard_normal((3, 13, 10)) * 2.0)
    logw = tuple(torch.as_tensor(rng.standard_normal((3, V, K)) - 4.0)
                 for V, K in zip(config.V, config.K))
    X = tuple(torch.as_tensor(rng.integers(0, 30, (13, V)).astype(np.float64)) for V in config.V)
    sumtheta, scatters = ctm_base.theta_moments(lam, logw, X, config)
    for m in range(config.M):
        st, sc = tk.theta_moments_fused_plain(config.block(lam, m), logw[m], X[m])
        np.testing.assert_allclose(config.block(sumtheta, m).numpy(), st.numpy(), rtol=1e-12)
        np.testing.assert_allclose(scatters[m].numpy(), sc.numpy(), rtol=1e-12)


@pytest.mark.parametrize("device, dtype, V, K, route", [
    ("cuda", torch.float32, 96, 7, "kernel"),
    ("cuda", torch.float32, 128, 128, "kernel"),
    ("cuda", torch.float32, 129, 7, "factorized"),
    ("cuda", torch.float32, 96, 129, "factorized"),
    ("cuda", torch.float64, 96, 7, "factorized"),
    ("cpu", torch.float32, 96, 7, "factorized"),
    ("cpu", torch.float64, 96, 7, "factorized"),
])
def test_theta_route(device, dtype, V, K, route):
    assert ctm_base._theta_route(device, dtype, V, K) == route


@pytest.mark.parametrize("device, dtype, MK, route", [
    ("cuda", torch.float32, 14, "kernel"),
    ("cuda", torch.float32, 40, "kernel"),
    ("cuda", torch.float32, 128, "kernel"),
    ("cuda", torch.float32, 129, "plain"),
    ("cuda", torch.float64, 14, "plain"),
    ("cpu", torch.float32, 14, "plain"),
    ("cpu", torch.float64, 40, "plain"),
])
def test_lambda_route(device, dtype, MK, route):
    assert ctm_base._lambda_route(device, dtype, MK) == route


@pytest.mark.parametrize("V, K", [(129, 7), (96, 129)])
def test_wrapper_raises_over_the_kernel_limits(V, K):
    with pytest.raises(ValueError, match="exceeds the θ kernel's limits"):
        tk.theta_moments_fused(torch.zeros(1, 4, K), torch.zeros(1, V, K), torch.zeros(4, V))


def test_cpu_tensors_take_the_plain_version_without_a_launch(rng):
    args = list(map(torch.as_tensor, _inputs(rng, 2, 9, 12, 3)))
    before = tk.LAUNCHES
    got = tk.theta_moments_fused(*args)
    want = tk.theta_moments_fused_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tk.LAUNCHES == before


def test_other_devices_raise(rng):
    args = [torch.as_tensor(a).to("meta") for a in _inputs(rng, 1, 4, 5, 2)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.theta_moments_fused(*args)


def test_theta_moments_on_cpu_never_reaches_the_kernel(rng, monkeypatch):
    """CPU tensors of any dtype keep the factorized schedule."""
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the θ kernel wrapper")

    monkeypatch.setattr(tk, "theta_moments_fused", no_kernel)
    config = MMCTMConfig(K=(2, 2), V=(5, 4), D=3, dtype=torch.float32)
    lam = torch.zeros(1, 3, 4)
    logw = (torch.zeros(1, 5, 2), torch.zeros(1, 4, 2))
    X = (torch.ones(3, 5), torch.ones(3, 4))
    sumtheta, _ = ctm_base.theta_moments(lam, logw, X, config)
    torch.testing.assert_close(sumtheta, torch.cat([torch.full((1, 3, 2), 2.5),
                                                    torch.full((1, 3, 2), 2.0)], dim=-1))


@pytest.mark.parametrize("R, D, V, K, want", [
    # the BRCA shapes: V = 96 and V = 48 fill every lane
    (100, 560, 96, 7, dict(tile_docs=8, tile_items=4, item_groups=24, doc_rows=8,
                           docs_per_block=64, grid=(9, 100))),
    (100, 560, 48, 7, dict(tile_docs=4, tile_items=4, item_groups=12, doc_rows=16,
                           docs_per_block=64, grid=(9, 100))),
    (1, 560, 96, 7, dict(tile_docs=8, item_groups=24, doc_rows=8, grid=(9, 1))),
    (100, 561, 96, 7, dict(docs_per_block=64, grid=(9, 100))),
    (3, 37, 96, 7, dict(tile_docs=5, doc_rows=8, docs_per_block=40, grid=(1, 3))),
    (2, 8, 5, 2, dict(tile_items=4, item_groups=2, doc_rows=8, tile_docs=1, grid=(1, 2))),
])
def test_launch_geometry_at_the_brca_and_ragged_shapes(R, D, V, K, want):
    geo = tk.launch_geometry(R, D, V, K)
    assert {k: getattr(geo, k) for k in want} == want
    assert geo.scratch == R * geo.grid[0] * K * V and geo.counter == R


# the BRCA shapes, ragged ones, and K 9–128 (the chunk layout) at R = 1, 100
# and 1000 by D = 560 and V = 96, 48 and 24 (the vocab ranks' slices)
CHUNK_K = (9, 12, 20, 33, 40, 64, 65, 128)
SHAPES = [(100, 560, 96, 7), (100, 560, 48, 7), (1, 560, 96, 7), (100, 561, 96, 7),
          (3, 33, 128, 11), (2, 8, 5, 2), (2, 40, 24, 128), (3, 29, 128, 128), (7, 101, 96, 7),
          (1, 1, 1, 1), (4, 70, 97, 8), (2, 50, 20, 16), (2, 50, 64, 33),
          *((R, 560, V, K) for K in CHUNK_K for R in (1, 100, 1000) for V in (96, 48, 24))]


@pytest.mark.parametrize("R, D, V, K", SHAPES)
def test_launch_geometry_invariants(R, D, V, K):
    """The tile layout at K ≤ 8; above, the chunk layout's limits: the chunk
    within the Z tiles' reach, whole clusters of at most MAX_CLUSTER blocks, empty
    blocks only in the last cluster, at least BLOCK_MIN_DOCS documents a
    block at R·D ≥ FEW_DOCS, the scratch within R·⌈D/32⌉·K·V, and a block's
    shared memory under the H100's 227 KB; for every candidate the rule
    weighs."""
    for geo in tk._candidate_geometries(R, D, V, K):
        assert geo.grid[1] == R and geo.counter == R
        if K <= 8:
            smem = tk._smem_bytes(K, geo.item_groups, geo.doc_rows, geo.tile_docs,
                                  geo.tile_items)
            assert smem <= 227 * 1024  # a block's shared memory on the H100
            assert geo.layout == "tile" and geo.cluster == 1
            assert geo.item_groups == -(-V // geo.tile_items)
            assert geo.item_groups * geo.doc_rows <= tk.MAX_THREADS
            assert geo.docs_per_block == geo.doc_rows * geo.tile_docs <= tk.BLOCK_DOCS
            assert geo.grid == (-(-D // geo.docs_per_block), R)
            assert (geo.grid[0] - 1) * geo.docs_per_block < D  # no block without a document
            assert geo.scratch == R * geo.grid[0] * K * V
            if geo.tile_docs > 1:
                assert smem <= tk.MAX_SMEM
            continue
        assert geo.layout == "chunk" and geo.doc_rows == 1 and geo.tile_items == 0
        assert tk._chunk_smem_bytes(V, K, geo.chunk_docs) <= 227 * 1024
        assert geo.item_groups in (256, 512)
        _, zn = tk._chunk_tiles(V, geo.item_groups)
        assert 1 <= geo.chunk_docs <= min(geo.docs_per_block, zn * tk.Z_DOCS, tk.CHUNK_DOCS)
        assert 1 <= geo.cluster <= tk.MAX_CLUSTER and geo.grid[0] % geo.cluster == 0
        assert geo.docs_per_block == geo.tile_docs and geo.grid[0] * geo.docs_per_block >= D
        assert (geo.grid[0] - geo.cluster) * geo.docs_per_block < D
        if R * D >= tk.FEW_DOCS:
            assert geo.docs_per_block >= tk.BLOCK_MIN_DOCS
        clusters = geo.grid[0] // geo.cluster
        assert geo.scratch == (R * clusters * K * V if clusters > 1 else 0)
        assert geo.scratch <= R * -(-D // 32) * K * V


@pytest.mark.parametrize("R, D, V, K", SHAPES)
def test_the_geometry_covers_every_cell_once(R, D, V, K):
    """The kernel's map from (block, thread, tile slot) to (d, v), replayed
    in NumPy: every cell of the (D, V) counts falls in exactly one slot; in
    the chunk layout, that of the Z tiles, chunk by chunk."""
    g = tk.launch_geometry(R, D, V, K)
    hits = np.zeros((D, V), np.int64)
    if g.layout == "tile":
        b, tid, j, i = np.meshgrid(np.arange(g.grid[0]), np.arange(g.item_groups * g.doc_rows),
                                   np.arange(g.tile_docs), np.arange(g.tile_items), indexing="ij")
        vg, dg = tid % g.item_groups, tid // g.item_groups
        d = b * g.docs_per_block + dg * g.tile_docs + j
        v = vg + i * g.item_groups
        live = (d < D) & (v < V)
    else:
        nvz, zn = tk._chunk_tiles(V, g.item_groups)
        chunks = -(-g.tile_docs // g.chunk_docs)
        b, c, tid, i, j = np.meshgrid(np.arange(g.grid[0]), np.arange(chunks),
                                      np.arange(g.item_groups), np.arange(tk.Z_DOCS),
                                      np.arange(tk.Z_ITEMS), indexing="ij")
        dl = tid // nvz + i * zn
        d = b * g.docs_per_block + c * g.chunk_docs + dl
        v = tid % nvz + j * nvz
        block_end = np.minimum(D, (b + 1) * g.docs_per_block)
        live = (tid // nvz < zn) & (dl < g.chunk_docs) & (d < block_end) & (v < V)
    np.add.at(hits, (d[live], v[live]), 1)
    assert (hits == 1).all()


@pytest.mark.parametrize("V, K", [(96, 7), (48, 7)])
def test_brca_vocabularies_leave_no_lane_idle(V, K):
    geo = tk.launch_geometry(100, 560, V, K)
    assert geo.item_groups * geo.tile_items == V and geo.item_groups * geo.doc_rows % 32 == 0
