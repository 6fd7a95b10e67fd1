"""The port's profiling utilities (utils/profiling.py) on the CPU: the
Chrome trace with a named span, the NaN check that names the operation and
ends with its block, `check_finite` against the JAX package's on the same
NaN-holding state, the timer, and the program's spans and counters: off by
default, nested with parents, self times and entry ids, in the harness's
form, one `step` and one `loop.freeze` per CAVI step of a restart fit whose
bits do not change, and in the Chrome trace; and with the fit loops' chains
run as graphs (emulated on the CPU), their capture and replay counters and
the `step.tail` span."""

import json
import os

import numpy as np
import pytest
import torch

from multimodalmusig_tpu.utils import profiling as jprof

import multimodalmusig_tpu_torch as mt
from multimodalmusig_tpu_torch import cli
from multimodalmusig_tpu_torch.models import mmctm as tm
from multimodalmusig_tpu_torch.parallel import _ranks
from multimodalmusig_tpu_torch.utils import graphs, profiling

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Each test starts and ends with nothing recorded."""
    profiling.reset()
    yield
    profiling.reset()


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    logdir = os.path.join(tmp_path, "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("cavi-step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "cavi-step" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "cavi-step" for e in prof.key_averages())


def test_debug_nans_names_the_op_and_ends_with_its_block():
    x = torch.tensor([0.0, 1.0])
    with pytest.raises(FloatingPointError, match=r"aten\.div.*1 NaN values.*\(2,\)"):
        with profiling.debug_nans():
            x / x
    assert torch.isnan(x / x).sum() == 1  # the check ended with the block
    with profiling.debug_nans(enable=False):
        assert torch.isnan(x / x).sum() == 1
    with profiling.debug_nans():  # finite work passes through untouched
        assert torch.equal(x + 1, torch.tensor([1.0, 2.0]))


def _state():
    config = tm.MMCTMConfig(K=(2, 3), V=(4, 5), D=6, dtype=torch.float64)
    X = tuple(torch.ones(6, v, dtype=torch.float64) for v in config.V)
    return tm.init_with_alpha(torch.Generator().manual_seed(0), config, X, [0.1, 0.1],
                              restarts=2, device="cpu")


@pytest.mark.parametrize("field, index", [("gamma", 1), ("lam", None), ("Sigma", None)])
def test_check_finite_names_the_leaf_as_the_jax_function_does(field, index):
    """The same NaN-holding state (a NamedTuple of tensors, and of numpy
    arrays for the JAX function) gives the same message in both packages."""
    state = _state()
    profiling.check_finite(state)
    leaf = getattr(state, field)
    bad = leaf[index] if index is not None else leaf
    bad[0, 0, 0] = float("nan")
    bad[1, -1, -1] = float("inf")
    with pytest.raises(FloatingPointError) as got:
        profiling.check_finite(state, "model")
    with pytest.raises(FloatingPointError) as want:
        jprof.check_finite(_ranks.tree_map(lambda t: t.numpy(), state), "model")
    assert str(got.value) == str(want.value)
    assert f"model.{field}" in str(got.value) and ": 2/" in str(got.value)


def test_check_finite_ignores_integer_and_boolean_leaves():
    profiling.check_finite({"n": torch.tensor([1, 2]), "done": torch.tensor([True]),
                            "ll": np.array([-1.0])})


def test_timer_measures_the_block():
    with profiling.Timer() as t:
        torch.ones(128, 128) @ torch.ones(128, 128)
    with profiling.Timer(torch.ones(1)) as t2:
        pass
    assert t.elapsed > 0 and t2.elapsed >= 0 and t2.device.type == "cpu"


def _clock(monkeypatch, start=1000, step=10):
    """The tracer's clock as a counter: start, start + step, ..."""
    ticks = iter(range(start, 10**9, step))
    monkeypatch.setattr(profiling, "_time_ns", lambda: next(ticks))


def _sites():
    """Every kind of span site once, as the program writes them."""
    with profiling.entry("outer"):
        with profiling.span("a"):
            t = profiling.begin("b") if profiling.ON else None
            if t is not None:
                t = profiling.then(t, "c")
                profiling.end(t)
        if profiling.ON:
            profiling.count("n")
            profiling.count("lanes", torch.tensor([2, 3]))


def test_recording_is_off_by_default_and_records_nothing():
    assert not profiling.refresh()
    _sites()
    assert profiling.totals() == {"spans": {}, "counts": {}}
    assert profiling.spans() == [] and profiling.spans(full=True) == []
    with profiling.tracing():
        assert profiling.ON
    assert not profiling.ON


def test_spans_nest_with_parents_self_times_and_entry_ids(monkeypatch):
    _clock(monkeypatch)
    with profiling.tracing():
        _sites()
        _sites()
    full = profiling.spans(full=True)
    assert [r["name"] for r in full] == ["outer", "a", "b", "c"] * 2
    assert [r["parent"] for r in full] == [-1, 0, 1, 1, -1, 4, 5, 5]
    assert [r["entry"] for r in full] == [1] * 4 + [2] * 4
    # ticks of 10 ns: outer 1000-1060, a 1010-1050, b 1020-1030, c 1030-1040
    assert [(r["start_ns"], r["end_ns"]) for r in full[:4]] == [
        (1000, 1060), (1010, 1050), (1020, 1030), (1030, 1040)]
    t = profiling.totals()
    assert t["counts"] == {"n": 2, "lanes": 10}
    assert t["spans"]["outer"]["calls"] == 2
    assert t["spans"]["outer"]["s"] == pytest.approx(2 * 60e-9)
    assert t["spans"]["outer"]["self_s"] == pytest.approx(2 * 20e-9)
    assert t["spans"]["a"]["self_s"] == pytest.approx(2 * 20e-9)
    assert t["spans"]["c"]["self_s"] == t["spans"]["c"]["s"] == pytest.approx(2 * 10e-9)


def test_an_unclosed_inner_span_is_closed_with_its_parent(monkeypatch):
    _clock(monkeypatch)
    with profiling.tracing():
        outer = profiling.begin("outer")
        profiling.begin("left open")
        profiling.end(outer)
        profiling.end(outer)  # a second end changes nothing
    assert profiling.spans() == [(1000, 1020, "outer"), (1010, 1020, "left open")]


def test_spans_are_in_the_form_the_harness_summarizes():
    with profiling.tracing():
        _sites()
    got = profiling.spans()
    assert [name for _, _, name in got] == ["outer", "a", "b", "c"]
    for start, end, _ in got:
        assert isinstance(start, int) and isinstance(end, int) and start <= end
    assert [s for s, _, _ in got] == sorted(s for s, _, _ in got)
    assert abs(got[0][0] - __import__("time").time_ns()) < 60e9  # the system clock


def _tiny_docs(D=24):
    rng = np.random.default_rng(0)
    X = [rng.poisson(rng.gamma(1.0, 3.0, (D, 1)) * rng.dirichlet(np.ones(v), D) * 5)
         .astype(np.float64) for v in (10, 8)]
    return X, [[mt.make_count_matrix(X[m][d]) for m in range(2)] for d in range(D)]


def _restart_fit(docs):
    return mt.fit_mmctm_restarts([2, 2], [0.1, 0.1], docs, restarts=10, maxiter=30, seed=5,
                                 compact_schedule=(12,), device="cpu")


def test_a_traced_restart_fit_counts_its_steps_and_keeps_its_bits():
    """One `step` and one `loop.freeze` a CAVI step, the lane-iterations
    its results report, one entry id, and the same bits recording or not."""
    _, docs = _tiny_docs()
    plain = _restart_fit(docs)
    assert profiling.totals() == {"spans": {}, "counts": {}}
    with profiling.tracing():
        traced = _restart_fit(docs)
    t = profiling.totals()
    spans, counts = t["spans"], t["counts"]
    steps = counts["loop.steps"]
    assert steps > 0 and spans["step"]["calls"] == spans["loop.freeze"]["calls"] == steps
    for phase in ("step.estep", "step.mstep", "step.gamma", "step.ll"):
        assert spans[phase]["calls"] == steps
    assert spans["step"]["self_s"] < 0.5 * spans["step"]["s"]
    # stage 1 (every lane) and stage 2 (the selected model)
    assert counts["loop.lane_iters"] == (int(traced.restart_result.n_iters.sum())
                                         + len(traced.ll_history))
    assert steps <= counts["loop.lane_steps"] <= 10 * steps
    assert counts["loop.lane_steps"] >= counts["loop.lane_iters"]
    # stage 1: a boundary after 12 iterations and the final one; stage 2: one
    assert spans["loop.run"]["calls"] == 2 and counts["loop.boundaries"] == 3
    assert spans["loop.boundary"]["calls"] == 3
    assert counts["restarts.fits"] == spans["restarts.fit"]["calls"] == 1
    for phase in ("setup", "init", "rescore1", "graft", "rescore2", "collect"):
        assert spans[f"restarts.{phase}"]["calls"] == 1
    assert spans["restarts.finalize"]["calls"] == 2
    assert counts["loop.syncs"] == spans["loop.sync"]["calls"] > 0
    assert len({r["entry"] for r in profiling.spans(full=True)}) == 1
    assert traced.ll == plain.ll and traced.elbo == plain.elbo
    assert traced.ll_history == plain.ll_history
    for a, b in zip(traced.state, plain.state):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert torch.equal(traced.restart_result.ll_history, plain.restart_result.ll_history)
    assert torch.equal(traced.restart_result.state.lam, plain.restart_result.state.lam)


def test_the_cli_is_one_entry_with_its_read_and_write_spans(tmp_path):
    X, _ = _tiny_docs()
    paths = []
    for m, x in enumerate(X):
        path = tmp_path / f"m{m}.tsv"
        lines = ["term\t" + "\t".join(f"s{d}" for d in range(x.shape[0]))]
        lines += [f"t{v}\t" + "\t".join(str(int(c)) for c in x[:, v]) for v in range(x.shape[1])]
        path.write_text("\n".join(lines) + "\n")
        paths.append(str(path))
    argv = [*paths, "-k", "2", "2", "-m", "A", "B", "--restarts", "4", "--maxiter", "20",
            "--device", "cpu", "--props", str(tmp_path / "p.tsv")]
    with profiling.tracing():
        assert cli.main(argv) == 0
    full = profiling.spans(full=True)
    names = [r["name"] for r in full]
    assert names[0] == "cli.read" and names[-1] == "cli.write" and "restarts.fit" in names
    assert {r["entry"] for r in full} == {1}
    assert {r["parent"] for r in full if r["name"] in ("cli.read", "restarts.fit",
                                                      "cli.write")} == {-1}


def test_a_profiled_fit_traces_itself_and_its_spans_reach_the_chrome_trace(tmp_path):
    """Under a torch.profiler session alone the fit records its spans; under
    `trace()` they are ranges of its Chrome trace too."""
    X, _ = _tiny_docs(8)
    config = tm.MMCTMConfig(K=(2, 2), V=(10, 8), D=8, dtype=torch.float64)
    Xt = tm.counts_tensors(X, config, "cpu")
    state = tm.init_with_alpha(torch.Generator().manual_seed(0), config, Xt, [0.1, 0.1],
                               restarts=2, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tm.fit(state, Xt, config, maxiter=3, tol=0.0)
    assert profiling.totals()["counts"]["loop.steps"] == 3
    logdir = os.path.join(tmp_path, "trace")
    with profiling.trace(logdir):
        tm.fit(state, Xt, config, maxiter=2, tol=0.0)
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"loop.run", "step", "step.estep", "loop.freeze"} <= names
    profiling.refresh()
    assert not profiling.ON


class _Replay:
    """A CUDA graph's semantics on the CPU (utils/graphs.py `_record`): a
    replay runs the chain again on the capture's inputs and writes its
    outputs into the capture's."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        for o, n in zip(graphs.leaves(self.out), graphs.leaves(self.fn(*self.args))):
            if o is not n:
                o.copy_(n)

    def reset(self):
        pass


def test_graphed_chains_count_their_captures_and_replays_under_step_tail(monkeypatch):
    """A restart fit whose loops run their chains as graphs (emulated on the
    CPU; on the card they are CUDA graphs): per segment one warm-up and one
    capture of the tail and of the freeze, a replay at every later step;
    each replayed step's tail is one `step.tail` span in place of the eager
    phases; the bits of the fit without graphs."""
    _, docs = _tiny_docs()
    plain = _restart_fit(docs)

    def record(fn, args, device):
        out = fn(*args)
        return _Replay(fn, args, out), out

    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_record", record)
    with profiling.tracing():
        graphed = _restart_fit(docs)
    t = profiling.totals()
    spans, counts = t["spans"], t["counts"]
    steps = counts["loop.steps"]
    # stage 1 cut after 12 iterations, then stage 2: three segments
    segments = counts["loop.boundaries"]
    assert segments == 3
    for kind in ("tail", "freeze"):
        assert counts[f"graph.captures.{kind}"] == segments
        assert counts[f"graph.replays.{kind}"] == steps - 2 * segments
    assert spans["step.tail"]["calls"] == steps - segments
    for phase in ("step.mstep", "step.gamma", "step.ll"):
        assert spans[phase]["calls"] == segments
    assert spans["step"]["calls"] == spans["step.estep"]["calls"] == steps
    assert graphed.ll == plain.ll and graphed.ll_history == plain.ll_history
    assert torch.equal(graphed.restart_result.ll_history, plain.restart_result.ll_history)
    for a, b in zip(graphs.leaves(graphed.restart_result.state),
                    graphs.leaves(plain.restart_result.state)):
        assert torch.equal(a, b)
