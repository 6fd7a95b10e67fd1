"""The multi-device layer of the PyTorch port (parallel/sharding.py and
parallel/_ranks.py) on CPU ranks over gloo, against the JAX package's
sharding functions and against the port's own one-process fits.

Every case that starts ranks runs with parallel/_ranks.py's TIMEOUT_S cut to
RANK_TIMEOUT_S, so a hung rank fails its test instead of stalling the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import mmctm as jm
from multimodalmusig_tpu.parallel import restarts as jr
from multimodalmusig_tpu.parallel import sharding as js

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base as tcb, lda as tlda, mmctm as tm
from multimodalmusig_tpu_torch.ops.special import dirichlet_expectation, safe_xlogy
from multimodalmusig_tpu_torch.parallel import _ranks, sharding

torch.set_num_threads(2)

RANK_TIMEOUT_S = 120.0
CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def rank_timeout(monkeypatch):
    monkeypatch.setattr(_ranks, "TIMEOUT_S", RANK_TIMEOUT_S)


def _counts(seed, D, V):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 6, size=(D, v)).astype(np.float64) for v in V)


def _configs(D, V, K=(2, 2)):
    return (jm.MMCTMConfig(K=K, V=V, D=D, dtype=jnp.float64),
            tm.MMCTMConfig(K=K, V=V, D=D, dtype=torch.float64))


def _jax_inits(key, R, jcfg, X):
    keys = jax.random.split(jax.random.key(key), R)
    alpha = jnp.asarray([0.1, 0.1])
    Xj = tuple(jnp.asarray(x) for x in X)
    inits = jax.vmap(lambda k: jm.init_with_alpha(k, jcfg, Xj, alpha))(keys)
    return keys, alpha, Xj, inits


# --- the mesh ----------------------------------------------------------------


def test_make_mesh_shape_and_error():
    """As tests/test_parallel.py:128-130: the ("restart", "data") grid, and
    the JAX package's error when the devices run short."""
    mesh = sharding.make_mesh(2, 4, ["cpu"] * 8)
    assert mesh.shape == {"restart": 2, "data": 4}
    assert mesh.axis_names == ("restart", "data")
    assert js.make_mesh(2, 4, jax.devices("cpu")).shape == mesh.shape
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        sharding.make_mesh(2, 3, ["cpu"] * 4)
    with pytest.raises(ValueError, match="need 6 devices, have 4"):
        js.make_mesh(2, 3, jax.devices("cpu")[:4])


def test_backend_rule():
    """NCCL only for distinct CUDA cards; gloo on the CPU and for ranks that
    share a card."""
    assert _ranks.backend_for(CPU2) == "gloo"
    assert _ranks.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert _ranks.backend_for(["cuda", "cuda:0"]) == "gloo"
    assert _ranks.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert _ranks.backend_for(["cuda:0"]) == "nccl"


# --- MMCTM: restart fan-out and the restart x data mesh, against JAX -----------


@pytest.fixture(scope="module")
def jax_restarts():
    """3 JAX-initialized lanes on 8 documents, f64, and their JAX fit
    (fit_restarts_from_keys, 8 iterations)."""
    X = _counts(7, 8, (6, 5))
    jcfg, tcfg = _configs(8, (6, 5))
    keys, alpha, Xj, inits = _jax_inits(3, 3, jcfg, X)
    want = jr.fit_restarts_from_keys(keys, Xj, jcfg, alpha, maxiter=8, tol=1e-4)
    return X, tcfg, mt.state_from_numpy(inits, device="cpu"), want


def test_restart_fan_out_matches_jax_lanes_padded(jax_restarts):
    """R = 3 over 2 ranks pads to 4 by cycling; each lane's trajectory equals
    the JAX lane's at the trajectory standard, and the padding is dropped."""
    X, tcfg, state, want = jax_restarts
    info = {}
    got = sharding.shmap_fit_restarts_from_states(state, X, tcfg, maxiter=8, devices=CPU2,
                                                  run_info=info)
    assert got.ll.shape == (3, 2) and got.ll_history.shape == (3, 8, 2)
    np.testing.assert_allclose(got.ll_history.numpy(), np.asarray(want.ll_history), rtol=1e-10)
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(want.elbo), rtol=1e-10)
    np.testing.assert_array_equal(got.n_iters.numpy(), np.asarray(want.n_iters))
    assert info["backend"] == "gloo" and info["ranks"] == 2 and info["ranks_per_device"] == 2
    assert info["startup_s"] > 0 and info["fit_s"] > 0
    assert info["launches"] == [dict.fromkeys(_ranks.KERNELS, 0)] * 2  # the CPU runs no kernel


def test_restart_by_data_mesh_matches_jax_fit_restarts(jax_restarts):
    """A (2, 2) mesh: lanes over the rows (padded 3 -> 4), documents over the
    columns with the document sums all-reduced in each row, against the JAX
    fit_restarts lanes (the JAX sharded_fit_restarts is held to those)."""
    X, tcfg, state, want = jax_restarts
    got = sharding.sharded_fit_from_states(sharding.make_mesh(2, 2, ["cpu"] * 4), state, X, tcfg,
                                           maxiter=8)
    np.testing.assert_allclose(got.ll.numpy(), np.asarray(want.ll), rtol=1e-9)
    np.testing.assert_allclose(got.elbo.numpy(), np.asarray(want.elbo), rtol=1e-9)
    np.testing.assert_allclose(got.state.lam.numpy(), np.asarray(want.state.lam), rtol=1e-8,
                               atol=1e-10)


# --- MMCTM: the data-parallel fit --------------------------------------------


def _step_before_the_hook(X, N, cfg):
    """The CAVI step as it was written before the reduction hook, from the
    same primitives: the no-hook fit must give its bits."""
    def step(s):
        s, scatters = tm.e_step_moments(s, X, N, cfg)
        s = s._replace(mu=s.lam.mean(dim=-2))
        E = s.lam - s.mu.unsqueeze(-2)
        Sigma = (torch.diag_embed(s.nu.sum(dim=-2)) + E.mT @ E) / cfg.D
        s = s._replace(Sigma=Sigma, invSigma=tcb.spd_inverse(Sigma))
        gamma = tuple(s.alpha[:, m, None, None] + scatters[m] for m in range(cfg.M))
        s = s._replace(gamma=gamma,
                       Elnphi=tuple(dirichlet_expectation(g, axis=-1) for g in gamma))
        props, phi = tm.props_from(s.lam, cfg), tm.phi_point(s.gamma)
        return s, torch.stack([safe_xlogy(X[m], props[m] @ phi[m]).sum(dim=(-2, -1)) / X[m].sum()
                               for m in range(cfg.M)], dim=-1)
    return step


def test_data_parallel_fit_matches_jax_and_the_one_process_fit_keeps_its_bits():
    """8 documents over 2 ranks, 5 iterations, from one JAX init, against the
    JAX mmctm.fit at the JAX suite's tolerance (tests/test_parallel.py:148-171);
    and the one-process fit, which runs the same step with no hook, bit for
    bit the step as written before the hook."""
    X = _counts(5, 8, (4, 4))
    jcfg, tcfg = _configs(8, (4, 4))
    Xj = tuple(jnp.asarray(x) for x in X)
    jstate = jm.init_with_alpha(jax.random.key(2), jcfg, Xj, jnp.asarray([0.1, 0.1]))
    want = jax.jit(jm.fit, static_argnames=("config", "maxiter", "tol"))(jstate, Xj, jcfg,
                                                                        maxiter=5)
    state = mt.state_from_numpy(jstate, device="cpu")
    info = {}
    got = sharding.sharded_data_parallel_fit(sharding.make_mesh(1, 2, CPU2), state, X, tcfg,
                                             maxiter=5, run_info=info)
    np.testing.assert_allclose(got.ll[0].numpy(), np.asarray(want.ll), rtol=1e-8)
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=1e-8)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=1e-8)
    np.testing.assert_allclose(got.state.lam[0].numpy(), np.asarray(want.state.lam), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_allclose(got.state.Sigma[0].numpy(), np.asarray(want.state.Sigma),
                               rtol=1e-7, atol=1e-12)
    assert info["ranks"] == 2 and len(info["launches"]) == 2

    Xt = tm.counts_tensors(X, tcfg, "cpu")
    one = tm.fit(state, Xt, tcfg, maxiter=5)
    before = tcb.run_cavi(state, tcfg, 5, 1e-4, _step_before_the_hook(Xt, tcb.counts_per_doc(Xt),
                                                                      tcfg))
    assert torch.equal(one.ll_history, before[1]) and torch.equal(one.n_iters, before[2])
    for a, b in zip(_ranks_leaves(one.state), _ranks_leaves(before[0])):
        assert torch.equal(a, b)


def _ranks_leaves(tree):
    out = []
    _ranks.tree_map(out.append, tree)
    return out


# --- the family fan-outs ------------------------------------------------------


def _docs(X):
    return [mt.make_count_matrix(row) for row in X]


FEATURES = np.array([[1, 1], [1, 2], [2, 1], [2, 2], [3, 1], [3, 2]])


@pytest.mark.parametrize("family", ["LDA", "ILDA", "IMMCTM"])
def test_family_fan_out_matches_the_one_process_fit(family):
    """`devices=["cpu", "cpu"]` against the same call without it, f64: the
    same inits (5 lanes, padded to 6), the same lls to rtol 1e-12 and the same
    selected lane; the ranks' run is recorded as `model.rank_info`."""
    X = _counts(11, 16, (6, 6))
    kw = dict(restarts=5, maxiter=15, tol=1e-5, seed=3, dtype=torch.float64, device="cpu")
    if family == "LDA":
        def fit(**k):
            return mt.fit_lda_restarts(2, 0.1, 0.1, _docs(X[0]), **kw, **k)
    elif family == "ILDA":
        def fit(**k):
            return mt.fit_ilda_restarts(2, 0.1, 0.1, FEATURES, _docs(X[0]), **kw, **k)
    else:
        docs = [[mt.make_count_matrix(X[0][d]), mt.make_count_matrix(X[1][d])]
                for d in range(16)]

        def fit(**k):
            return mt.fit_immctm_restarts([2, 2], [0.1, 0.1], [FEATURES, FEATURES], docs,
                                          **kw, **k)
    plain, fanned = fit(), fit(devices=CPU2)
    np.testing.assert_allclose(fanned.restart_result.ll.numpy(), plain.restart_result.ll.numpy(),
                               rtol=1e-12)
    np.testing.assert_array_equal(fanned.restart_result.n_iters.numpy(),
                                  plain.restart_result.n_iters.numpy())
    np.testing.assert_allclose(fanned.ll, plain.ll, rtol=1e-12)
    lam = (fanned.state.lam, plain.state.lam)
    if family == "ILDA":
        lam = (lam[0][0], lam[1][0])
    np.testing.assert_allclose(lam[0].numpy(), lam[1].numpy(), rtol=1e-11)
    assert fanned.rank_info["backend"] == "gloo" and fanned.rank_info["ranks"] == 2
    assert not hasattr(plain, "rank_info")


@pytest.mark.parametrize("family", ["LDA", "ILDA", "IMMCTM"])
@pytest.mark.parametrize("cut", [dict(compact_schedule=(3,)), dict(compact_schedule="auto"),
                                 dict(chunk_iters=4)])
def test_devices_exclude_host_driven_compaction(family, cut):
    """The JAX message (restarts.py:1572-1577), before any rank starts."""
    X = _counts(11, 6, (6, 6))
    kw = dict(restarts=2, maxiter=3, device="cpu", devices=CPU2, **cut)
    with pytest.raises(ValueError, match="incompatible with chunk_iters/compact_schedule"):
        if family == "LDA":
            mt.fit_lda_restarts(2, 0.1, 0.1, _docs(X[0]), **kw)
        elif family == "ILDA":
            mt.fit_ilda_restarts(2, 0.1, 0.1, FEATURES, _docs(X[0]), **kw)
        else:
            docs = [[mt.make_count_matrix(X[0][d]), mt.make_count_matrix(X[1][d])]
                    for d in range(6)]
            mt.fit_immctm_restarts([2, 2], [0.1, 0.1], [FEATURES, FEATURES], docs, **kw)


def test_a_rank_that_raises_makes_the_call_raise():
    """A rank's error (here counts of the wrong width) comes back as a
    RuntimeError with the rank's traceback; nothing carries on."""
    cfg = mt.LDAConfig(K=2, V=6, D=4, alpha=0.1, eta=0.1, dtype=torch.float64)
    state = tlda.init(torch.Generator().manual_seed(0), cfg, restarts=2, device="cpu")
    with pytest.raises(RuntimeError, match=r"rank \d on cpu raised"):
        mt.fit_lda_restarts_from_states(state, np.ones((4, 5)), cfg, maxiter=2, devices=CPU2)


def test_dryrun_multichip():
    """Every multi-device path on 4 CPU ranks against the one-process fit
    (the JAX package's dryrun_multichip), its vocab-sharded fit included."""
    sharding.dryrun_multichip(4)

