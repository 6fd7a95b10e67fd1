"""The reader of `cavi.graph_share` (portbench/metrics/cavi.graph_share.py):
on synthetic totals of the program's counters, on a program that counts no
graph (None), and on a tiny CPU run whose fit loops run their chains as
graphs, a CUDA graph's semantics emulated on the CPU: the run is correct
and the share is the tail's replays over the steps."""

import types

import pytest

from portbench import corpus, harness, program_trace, spec
from portbench.instrument import Recorder

from multimodalmusig_tpu_torch.utils import profiling

COUNTS = {"loop.steps": 200, "loop.lane_steps": 12000, "restarts.fits": 2}


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _fake(monkeypatch, counts=COUNTS):
    spans = {"step": {"calls": 200, "s": 0.3, "self_s": 0.3}}
    fake = types.SimpleNamespace(totals=lambda: {"spans": spans, "counts": counts},
                                 spans=lambda full=False: [])
    monkeypatch.setattr(program_trace, "_profiling", lambda: fake)


def _run(lane_steps):
    """A traced run's record whose profiled set, the one this reader reads,
    holds what the program's tracer holds now."""
    return {"program": {"profiled": program_trace.snapshot(lane_steps)}}


def test_the_graph_share_reads_the_tail_replays_over_the_steps(monkeypatch):
    read = spec.load_metric("cavi.graph_share")
    _fake(monkeypatch, counts=dict(COUNTS, **{"graph.captures.tail": 5,
                                              "graph.replays.tail": 190}))
    assert read(_run(12000)) == pytest.approx(95.0)
    assert read({"program": {"unprofiled": program_trace.snapshot(12000)}}) is None
    _fake(monkeypatch, counts=dict(COUNTS, **{"graph.captures.tail": 5}))  # none replayed
    assert read(_run(12000)) == 0.0
    _fake(monkeypatch)  # a program that counts no graph: the parent of this reader
    assert read(_run(12000)) is None
    assert read(_run(11999)) is None
    assert read({}) is None
    monkeypatch.setattr(program_trace, "_profiling", lambda: None)
    assert read(_run(12000)) is None


class _Replay:
    """A CUDA graph's semantics on the CPU (utils/graphs.py `_record`): a
    replay runs the chain again on the capture's inputs and writes its
    outputs into the capture's."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        from multimodalmusig_tpu_torch.utils import graphs

        for o, n in zip(graphs.leaves(self.out), graphs.leaves(self.fn(*self.args))):
            if o is not n:
                o.copy_(n)

    def reset(self):
        pass


def test_a_tiny_run_with_graphed_chains_is_correct_and_reads_its_graph_share(
        tiny, tmp_path, monkeypatch):
    """The tiny cell with the fit loops' chains run as graphs (emulated on
    the CPU): the harness still sees every step, the run is correct, and
    the graph share is the tail's replays over the steps."""
    from multimodalmusig_tpu_torch.utils import graphs

    def record(fn, args, device):
        out = fn(*args)
        return _Replay(fn, args, out), out

    monkeypatch.setattr(graphs, "DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_record", record)
    bench, base = tiny
    r = spec.resolve(bench, "tiny_mmctm.api", base=base)
    result = harness.run_cell(r, 2**31 + 17, 0.5, 0, device="cpu")
    assert result["correct"], result["checks"]
    prog = harness.program(r["entry"])
    recorder = Recorder(prog, r["entry"].HOOKS)
    recorder.install()
    try:
        job = r["entry"].Job(prog, r["config"], r["traffic"], corpus.load(r["config"]),
                             str(tmp_path / "out"), "cpu", recorder.span)
        with profiling.tracing():
            assert job.run(harness.fit_seed(2**31 + 17, 0))
    finally:
        recorder.uninstall()
    counts = profiling.totals()["counts"]
    assert counts["loop.lane_steps"] == recorder.lane_steps
    assert 0 < counts["graph.replays.tail"] < counts["loop.steps"]
    share = spec.load_metric("cavi.graph_share", base)(_run(recorder.lane_steps))
    assert share == pytest.approx(100.0 * counts["graph.replays.tail"] / counts["loop.steps"])
