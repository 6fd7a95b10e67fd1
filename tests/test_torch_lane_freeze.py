"""The fit loop's lane freeze (models/ctm_base.py `_LaneFreeze`) over a
device iteration, on the CPU: it leaves the carry bit for bit as the freeze
before it did (kept here as `_reference_run_cavi_from`: a host iteration,
torch.where out of place) for MMCTM, IMMCTM, LDA and ILDA carries, through
the wrap of the ll row at it = 0, the MIN_ITERS_BEFORE_CONVERGENCE gate, a
lane that goes non-finite, the E-step's lam_pre (the carry's own λ) and a
fit cut into calls. Then the same fits with the loop's chains run as
graphs, a CUDA graph's semantics emulated on the CPU (utils/graphs.py
`_record`: the capture's inputs read where they lie, its outputs rewritten
in place by each replay): the same bits, the graph counters, and the
`step.tail` span in place of the eager phases."""

import numpy as np
import pytest
import torch

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch.models import ctm_base, ilda, immctm, lda
from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.ops.convergence import relative_change
from multimodalmusig_tpu_torch.utils import graphs, profiling

torch.set_num_threads(2)

MAXITER = 30


def _select_lanes(keep, new, old):
    if isinstance(new, tuple):
        parts = [_select_lanes(keep, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    return torch.where(keep.view(-1, *([1] * (new.dim() - 1))), new, old)


def _reference_run_cavi_from(carry, maxiter, tol, step_fn, max_new_iters=None):
    """The loop as it was before its freeze ran over a device iteration."""
    state, ll_buf, n_iters, done = carry
    running = n_iters[~done].unique().tolist()
    it0 = running[0] if running else maxiter
    it_end = maxiter if max_new_iters is None else min(maxiter, it0 + int(max_new_iters))
    for it in range(it0, it_end):
        new_state, ll_i = step_fn(state)
        active = ~done
        state = _select_lanes(active, new_state, state)
        ll_buf[:, it] = _select_lanes(active, ll_i, ll_buf[:, it])
        n_iters = n_iters + active
        stop = ~torch.isfinite(ctm_base._per_lane(ll_i)).all(dim=-1)
        if it + 1 > ctm_base.MIN_ITERS_BEFORE_CONVERGENCE:
            stop = stop | (relative_change(ctm_base._per_lane(ll_buf[:, it - 1]),
                                           ctm_base._per_lane(ll_i)) < tol)
        done = done | (active & stop)
        if (it + 1) % ctm_base.DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
    return state, ll_buf, n_iters, done


def _docs(rng, D, V):
    counts = rng.poisson(rng.gamma(1.0, 3.0, (D, 1)) * rng.dirichlet(np.ones(V), D) * 5)
    return [mt.make_count_matrix(row.astype(np.float64)) for row in counts]


def _mmctm(autoalpha=False):
    rng = np.random.default_rng(0)
    per = [_docs(rng, 20, v) for v in (10, 8)]
    docs = [[per[0][d], per[1][d]] for d in range(20)]
    model = mt.MMCTM([2, 3], [0.1, 0.1], [10, 8], docs, device="cpu")
    state = tm.init_with_alpha(torch.Generator().manual_seed(1), model.config, model.Xdense,
                               [0.1, 0.1], restarts=4, device="cpu")
    X = model.Xdense
    return model.config, state, tm.fit_step_fn(X, ctm_base.counts_per_doc(X), model.config,
                                               autoalpha=autoalpha)


def _immctm():
    rng = np.random.default_rng(3)
    features = [np.array([[a, b] for a in (1, 2, 3) for b in (1, 2, 3, 4)]),
                np.array([[a, b] for a in (1, 2) for b in (1, 2, 3)])]
    per = [_docs(rng, 20, len(f)) for f in features]
    docs = [[per[0][d], per[1][d]] for d in range(20)]
    model = mt.IMMCTM([3, 2], [0.1, 0.1], features, docs, device="cpu")
    config = model.config
    state = immctm.init(torch.Generator().manual_seed(1), config, [[0.1, 0.1]] * 2, restarts=4,
                        device="cpu")
    X = model.Xdense
    return config, state, immctm.fit_step_fn(X, ctm_base.counts_per_doc(X), model.F, config)


def _lda():
    model = mt.LDA(3, 0.1, 0.1, 12, _docs(np.random.default_rng(5), 20, 12), device="cpu")
    state = lda.init(torch.Generator().manual_seed(1), model.config, restarts=4, device="cpu")
    return model.config, state, lda.fit_step_fn(model.Xdense, model.config)


def _ilda():
    features = np.array([[a, b] for a in (1, 2, 3) for b in (1, 2, 3, 4)])
    model = mt.ILDA(3, 0.1, 0.1, features, _docs(np.random.default_rng(6), 20, 12), device="cpu")
    state = ilda.init(torch.Generator().manual_seed(1), model.config, restarts=4, device="cpu")
    return model.config, state, ilda.fit_step_fn(model.Xdense, model.F, model.config)


FAMILIES = {"MMCTM": _mmctm, "MMCTM autoalpha": lambda: _mmctm(autoalpha=True),
            "IMMCTM": _immctm, "LDA": _lda, "ILDA": _ilda}


def _with_dead_lane(state):
    """Lane 1 of the state with a NaN in a field its first step reads: λ
    of the CTM families, E[ln β] of LDA and ILDA (λ is overwritten there)."""
    name = "lam" if hasattr(state, "lam_pre") else "Elnbeta"
    field = getattr(state, name)
    first = (field[0] if isinstance(field, tuple) else field).clone()
    first[1].view(-1)[0] = torch.nan
    return state._replace(**{name: (first, *field[1:]) if isinstance(field, tuple) else first})


def _same(a, b):
    xs, ys = graphs.leaves(a), graphs.leaves(b)
    return len(xs) == len(ys) and all(x.shape == y.shape and torch.equal(x.nan_to_num(7.0),
                                                                         y.nan_to_num(7.0))
                                      for x, y in zip(xs, ys))


def _scenario(name, config, state, step, monkeypatch):
    """(carry, tol, cuts) of a scenario, the carry fresh."""
    tol, cuts = 1e-4, (None,)
    if name == "gate":
        tol = 1.0  # every lane converges at the first iteration the gate opens
    elif name == "dead lane":
        state = _with_dead_lane(state)
    elif name == "cut":
        cuts = (3, 8, 1, None)
    carry = ctm_base.make_cavi_carry(state, config, MAXITER)
    if name == "wrap":
        # the gate open from the first iteration, whose previous ll is the
        # buffer's last row: lanes 0 and 2 find there the ll they step to
        monkeypatch.setattr(ctm_base, "MIN_ITERS_BEFORE_CONVERGENCE", 0)
        _, ll = step(state)
        carry[1][[0, 2], -1] = ll[[0, 2]]
        carry[1][[1, 3], -1] = 2 * ll[[1, 3]]
    return carry, tol, cuts


def _copy(carry):
    return ctm_base._map_tree(torch.clone, carry)


def _run(carry, tol, step, cuts):
    for cut in cuts:
        carry = ctm_base.run_cavi_from(carry, MAXITER, tol, step, max_new_iters=cut)
    return carry


SCENARIOS = ["whole", "cut", "gate", "dead lane", "wrap", "lam_pre"]


@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_the_freeze_keeps_the_bits_of_the_host_iterations_freeze(family, scenario, monkeypatch):
    config, state, step = FAMILIES[family]()
    carry, tol, cuts = _scenario(scenario, config, state, step, monkeypatch)
    if scenario == "lam_pre":
        cuts = (1, None)
    want = _reference_run_cavi_from(_copy(carry), MAXITER, tol, step)
    before = _copy(carry)
    got = _run(carry, tol, step, cuts)
    assert _same(got, want)
    assert _same(carry[0], before[0]) and _same(carry[2:], before[2:])  # the input left as it was
    n_iters, done = got[2], got[3]
    if scenario == "gate":
        assert n_iters.tolist() == [ctm_base.MIN_ITERS_BEFORE_CONVERGENCE + 1] * 4
    if scenario == "dead lane":
        assert n_iters[1] == 1 and done[1] and not torch.isfinite(got[1][1, 0]).all()
        assert (n_iters[[0, 2, 3]] > 1).all()
    if scenario == "wrap":
        assert n_iters.tolist()[0::2] == [1, 1] and (n_iters[1::2] > 1).all()
    if scenario == "lam_pre" and hasattr(state, "lam_pre"):
        one = ctm_base.run_cavi_from(_copy(carry), MAXITER, tol, step, max_new_iters=1)
        assert torch.equal(one[0].lam_pre, carry[0].lam)  # the λ the step started from


def test_the_verbose_loop_prints_the_reference_lines(capsys):
    config, state, step = _mmctm()
    carry = ctm_base.make_cavi_carry(state, config, 12)
    ctm_base.run_cavi_from(carry, 12, 1.0, step, verbose=True)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "\t" in ln]
    # every lane converges at the gate's first iteration, the 11th
    assert [ln.split("\t")[0] for ln in lines] == [str(i) for i in range(1, 12)]
    assert lines[0].startswith("1\tLog-likelihoods: [[")
    single = ctm_base.make_cavi_carry(ctm_base._index_lanes(state, torch.tensor([0])), config, 4)
    ctm_base.run_cavi_from(single, 4, 0.0, step, verbose=True, verbose_label="ll")
    assert capsys.readouterr().out.splitlines()[3].startswith("4\tll: [")


class _Replay:
    """A CUDA graph's semantics on the CPU: each replay runs the chain again
    on the capture's input tensors and writes its outputs into the
    capture's outputs."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        for o, n in zip(graphs.leaves(self.out), graphs.leaves(self.fn(*self.args))):
            if o is not n:
                o.copy_(n)

    def reset(self):
        self.fn = self.args = self.out = None


@pytest.fixture
def emulated_graphs(monkeypatch):
    """Fit loops on the CPU open segments and run their chains as emulated
    graphs."""
    def record(fn, args, device):
        out = fn(*args)
        return _Replay(fn, args, out), out

    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_record", record)
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("scenario", ["whole", "cut", "dead lane"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_graphed_chains_keep_the_bits_and_count_their_replays(family, scenario, monkeypatch,
                                                              emulated_graphs):
    config, state, step = FAMILIES[family]()
    carry, tol, cuts = _scenario(scenario, config, state, step, monkeypatch)
    want = _reference_run_cavi_from(_copy(carry), MAXITER, tol, step)
    sizes = []  # the steps of each segment
    with profiling.tracing():
        for cut in cuts:
            before = profiling.totals()["counts"].get("loop.steps", 0)
            carry = ctm_base.run_cavi_from(carry, MAXITER, tol, step, max_new_iters=cut)
            sizes.append(profiling.totals()["counts"]["loop.steps"] - before)
    assert _same(carry, want)
    t = profiling.totals()
    counts, spans = t["counts"], t["spans"]
    steps = sum(sizes)
    # a segment warms its chains at its first step and captures them at its
    # second, then replays them
    warm = sum(n >= 1 for n in sizes)
    captures = sum(n >= 2 for n in sizes)
    assert counts["loop.steps"] == steps and captures >= 1
    assert counts["graph.captures.freeze"] == captures
    assert counts["graph.replays.freeze"] == steps - warm - captures
    if family.startswith("MMCTM"):
        assert counts["graph.captures.tail"] == captures
        assert counts["graph.replays.tail"] == steps - warm - captures
        assert spans["step.tail"]["calls"] == steps - warm
        assert spans["step.mstep"]["calls"] == spans["step.ll"]["calls"] == warm
        assert spans["step"]["calls"] == steps
    else:
        assert "graph.captures.tail" not in counts and "step.tail" not in spans


def test_a_fit_outside_a_segment_and_with_a_hook_keeps_its_tail_eager(emulated_graphs):
    """A direct call of the step has no segment; a step with a `reduce` hook
    keeps its collectives eager; the freeze of the hooked loop is graphed."""
    config, state, step = _mmctm()
    with profiling.tracing():
        step(state)
        step(state)
    assert profiling.totals()["spans"]["step.mstep"]["calls"] == 2
    profiling.reset()

    class Identity:
        def __call__(self, tensors):
            return list(tensors)

        def agree(self, done):
            return done.clone()

    X = tm.counts_tensors([np.asarray(x) for x in (np.ones((20, 10)), np.ones((20, 8)))],
                          config, "cpu")
    hooked = tm.fit_step_fn(X, ctm_base.counts_per_doc(X), config, reduce=Identity())
    carry = ctm_base.make_cavi_carry(state, config, 12)
    with profiling.tracing():
        ctm_base.run_cavi_from(carry, 12, 0.0, hooked, reduce=Identity())
    counts = profiling.totals()["counts"]
    assert counts["graph.replays.freeze"] == 10 and "graph.replays.tail" not in counts


def test_a_chain_runs_eagerly_where_a_pinned_input_has_moved(emulated_graphs):
    buf, fresh = torch.zeros(3), torch.ones(3)

    def add(a, b):
        return a + b

    with graphs.segment("cpu", [buf]) as seg:
        c = seg.chain("tail", add)
        c.warm = True
        assert torch.equal(c(buf, fresh), torch.ones(3))       # captured
        out = c(buf, torch.full((3,), 2.0))                    # replayed, b copied in
        assert out is c.out and torch.equal(out, torch.full((3,), 2.0))
        assert torch.equal(fresh, torch.full((3,), 2.0))       # the capture's b took it
        moved = c(torch.ones(3), torch.ones(3))                # a moved: eager
        assert moved is not c.out and torch.equal(moved, torch.full((3,), 2.0))
        assert torch.equal(out, torch.full((3,), 2.0)) and torch.equal(buf, torch.zeros(3))
    assert c.graph is None and c.static is None and not seg.chains
    with graphs.segment("cpu") as seg:
        assert graphs.chain("tail", add, torch.ones(1)) is seg.chain("tail", add)
    assert graphs.chain("tail", add, torch.ones(1)) is None
