"""The vocab-sharded MMCTM fit of the PyTorch port
(parallel/sharding.py `sharded_vocab_parallel_fit`) on CPU ranks over gloo,
against the JAX package's vocab-sharded check, and the `vocab_reduce` hook
of models/ctm_base.py and models/mmctm.py in one process.

Every case that starts ranks runs with parallel/_ranks.py's TIMEOUT_S cut to
RANK_TIMEOUT_S, so a hung rank fails its test instead of stalling the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalmusig_tpu.models import mmctm as jm

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.parallel import _ranks, sharding

torch.set_num_threads(2)

RANK_TIMEOUT_S = 120.0
CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def rank_timeout(monkeypatch):
    monkeypatch.setattr(_ranks, "TIMEOUT_S", RANK_TIMEOUT_S)


def _problem(mmctm_fixture, V, D=4):
    """tests/test_parallel.py `TestVocabSharding`'s inputs: counts from
    default_rng(11), the fixture's K, D = 4, JAX init key(4), f64."""
    rng = np.random.default_rng(11)
    X = tuple(rng.integers(0, 6, size=(D, v)).astype(np.float64) for v in V)
    K = tuple(mmctm_fixture["K"])
    jcfg = jm.MMCTMConfig(K=K, V=tuple(V), D=D, dtype=jnp.float64)
    tcfg = tm.MMCTMConfig(K=K, V=tuple(V), D=D, dtype=torch.float64)
    Xj = tuple(jnp.asarray(x) for x in X)
    jstate = jm.init_with_alpha(jax.random.key(4), jcfg, Xj, [0.1, 0.1])
    return X, Xj, jcfg, tcfg, jstate


@pytest.mark.parametrize("V", [(8, 8), (5, 7)], ids=["even", "uneven"])
def test_vocab_sharded_fit_matches_jax(mmctm_fixture, V):
    """JAX `TestVocabSharding`'s case (tests/test_parallel.py:186-225) on two
    gloo ranks, and the same at an uneven split V = (5, 7) (3 + 2 and 4 + 3
    items a rank): ll, ll_history and the ELBO against the JAX mmctm.fit at
    rtol 1e-8, λ at 1e-7 and the joined γ at 1e-8; the result comes back
    whole, with each rank's launches recorded."""
    X, Xj, jcfg, tcfg, jstate = _problem(mmctm_fixture, V)
    want = jax.jit(jm.fit, static_argnames=("config", "maxiter", "tol"))(jstate, Xj, jcfg,
                                                                        maxiter=5)
    state = mt.state_from_numpy(jstate, device="cpu")
    info = {}
    got = sharding.sharded_vocab_parallel_fit(CPU2, state, X, tcfg, maxiter=5, run_info=info)
    np.testing.assert_allclose(got.ll[0].numpy(), np.asarray(want.ll), rtol=1e-8)
    np.testing.assert_allclose(got.ll_history[0].numpy(), np.asarray(want.ll_history), rtol=1e-8)
    np.testing.assert_allclose(float(got.elbo[0]), float(want.elbo), rtol=1e-8)
    np.testing.assert_allclose(got.state.lam[0].numpy(), np.asarray(want.state.lam), rtol=1e-7,
                               atol=1e-10)
    for m in range(2):
        assert got.state.gamma[m].shape == (1, tcfg.K[m], V[m])
        np.testing.assert_allclose(got.state.gamma[m][0].numpy(), np.asarray(want.state.gamma[m]),
                                   rtol=1e-8)
        assert got.state.logw_pre[m].shape == (1, V[m], tcfg.K[m])
    assert info["backend"] == "gloo" and info["ranks"] == 2
    assert info["launches"] == [dict.fromkeys(_ranks.KERNELS, 0)] * 2  # the CPU runs no kernel


class _Slices:
    """A `vocab_reduce` for one process that holds every slice: it returns
    each tensor as given (so the hooked fit must keep the unhooked fit's
    bits) and counts its calls, and `agree` returns the flags."""

    def __init__(self):
        self.calls = 0

    def __call__(self, tensors):
        self.calls += 1
        return list(tensors)

    def agree(self, done):
        return done


def test_the_vocab_hook_on_one_slice_keeps_the_unhooked_bits_and_reduces_three_times_a_step(
        mmctm_fixture):
    """With one slice the hooked fit is the unhooked fit bit for bit (the
    row sums of γ are formed once a step for both E[ln ϕ] and ϕ, as without
    the hook); the hook is called twice per fit (N and the ll counts), three
    times per CAVI step (sumθ, γ's row sums, the lls) and twice for the
    final ELBO (its sumθ and its six sums per modality)."""
    X, _, _, tcfg, jstate = _problem(mmctm_fixture, (8, 8))
    state = mt.state_from_numpy(jstate, device="cpu")
    Xt = tm.counts_tensors(X, tcfg, "cpu")
    hook = _Slices()
    hooked = tm.fit(state, Xt, tcfg, maxiter=5, tol=0.0, vocab_reduce=hook)
    plain = tm.fit(state, Xt, tcfg, maxiter=5, tol=0.0)
    assert hook.calls == 2 + 3 * 5 + 2
    for a, b in zip(_leaves(hooked), _leaves(plain)):
        assert torch.equal(a, b)


def test_the_vocab_hook_rejects_autoalpha():
    """autoα's sums over V are not reduced, so the hook refuses it."""
    cfg = tm.MMCTMConfig(K=(2, 2), V=(4, 4), D=3, dtype=torch.float64)
    with pytest.raises(ValueError, match="autoalpha"):
        tm.fit_step_fn((torch.ones(3, 4),) * 2, torch.ones(3, 2), cfg, autoalpha=True,
                       vocab_reduce=_Slices())


def _leaves(tree):
    out = []
    _ranks.tree_map(out.append, tree)
    return out


def _result(mmctm_fixture):
    X, _, _, tcfg, jstate = _problem(mmctm_fixture, (8, 8))
    state = mt.state_from_numpy(jstate, device="cpu")
    return tm.fit(state, tm.counts_tensors(X, tcfg, "cpu"), tcfg, maxiter=3)


def _halves(result):
    """The result as two vocab ranks would send it: γ, E[ln ϕ] and logw_pre
    split 4 + 4 along V, everything else replicated."""
    def half(i):
        cut = slice(4 * i, 4 * i + 4)
        s = result.state
        return result._replace(state=s._replace(
            gamma=tuple(g[:, :, cut] for g in s.gamma),
            Elnphi=tuple(e[:, :, cut] for e in s.Elnphi),
            logw_pre=tuple(w[:, cut] for w in s.logw_pre)))
    return [half(0), half(1)]


def test_the_join_puts_the_slices_back_in_rank_order(mmctm_fixture):
    result = _result(mmctm_fixture)
    joined = sharding._join_vocab(_halves(result))
    for a, b in zip(_leaves(joined), _leaves(result)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field", ["lam", "Sigma", "ll_history", "elbo"])
def test_the_join_raises_on_a_one_ulp_difference_between_ranks(mmctm_fixture, field):
    """A replicated field one ulp apart on rank 1 is a fault: the join
    raises rather than pick a rank's value."""
    result = _result(mmctm_fixture)
    parts = _halves(result)
    owner = parts[1].state if field in ("lam", "Sigma") else parts[1]
    value = getattr(owner, field).clone()
    flat = value.view(-1)
    flat[0] = torch.nextafter(flat[0], torch.tensor(np.inf, dtype=value.dtype))
    if owner is parts[1]:
        parts[1] = parts[1]._replace(**{field: value})
    else:
        parts[1] = parts[1]._replace(state=owner._replace(**{field: value}))
    with pytest.raises(RuntimeError, match=f"vocab rank 1's (state.)?{field} differs"):
        sharding._join_vocab(parts)


def test_a_modality_with_fewer_items_than_ranks_raises_before_any_rank_starts():
    cfg = tm.MMCTMConfig(K=(2, 2), V=(8, 2), D=4, dtype=torch.float64)
    X = (np.ones((4, 8)), np.ones((4, 2)))
    state = tm.init_with_alpha(torch.Generator().manual_seed(0), cfg,
                               tm.counts_tensors(X, cfg, "cpu"), [0.1, 0.1], device="cpu")
    with pytest.raises(ValueError, match="modality 1 has 2 vocabulary items, which cannot be "
                                         "split over 3 vocab ranks"):
        sharding.sharded_vocab_parallel_fit(["cpu"] * 3, state, X, cfg, maxiter=2)
