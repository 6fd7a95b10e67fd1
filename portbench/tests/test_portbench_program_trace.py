"""The readers of the program's own spans and counters
(portbench/program_trace.py and the metrics that read it): on synthetic
totals, on nothing, on a lane-step mismatch, and on a tiny CPU run traced by
the program itself, whose counts must equal those of the harness's
wrappers; and the trace's summary charging an idle gap to the program's
innermost span."""

import types

import pytest

from portbench import corpus, harness, program_trace, spec, trace
from portbench.instrument import Recorder

from multimodalmusig_tpu_torch.utils import profiling

NEW = ("cavi.dispatch_ms", "cavi.freeze_ms", "restarts.boundary_ms",
       "restarts.outside_loops_share", "kernel.launch_host_us")


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _span(s, calls):
    return {"calls": calls, "s": s, "self_s": s}


# two fits of 10 s, loop.run 5 + 2 s inside each (in the second, 5 s inside its
# pilot), and one loop.run outside both
SPANS = {"restarts.fit": _span(20.0, 2), "loop.run": _span(15.0, 5),
         "step": _span(0.3, 200), "loop.freeze": _span(0.1, 200),
         "loop.boundary": _span(0.004, 4),
         "kernel.eta_host": _span(0.002, 200),
         "kernel.theta_host": _span(0.004, 400)}
COUNTS = {"loop.steps": 200, "loop.lane_steps": 12000, "restarts.fits": 2}
RECORDS = ([{"name": "restarts.fit", "start_ns": 0, "end_ns": 10 * 10**9, "parent": -1},
            {"name": "loop.run", "start_ns": 1 * 10**9, "end_ns": 6 * 10**9, "parent": 0},
            {"name": "loop.run", "start_ns": 7 * 10**9, "end_ns": 9 * 10**9, "parent": 0},
            {"name": "restarts.fit", "start_ns": 11 * 10**9, "end_ns": 21 * 10**9,
             "parent": -1},
            {"name": "restarts.pilot", "start_ns": 12 * 10**9, "end_ns": 17 * 10**9 + 5 * 10**8,
             "parent": 3},
            {"name": "loop.run", "start_ns": 12 * 10**9, "end_ns": 17 * 10**9, "parent": 4},
            {"name": "loop.run", "start_ns": 18 * 10**9, "end_ns": 20 * 10**9, "parent": 3},
            {"name": "loop.run", "start_ns": 22 * 10**9, "end_ns": 23 * 10**9, "parent": -1}])
WANT = {"cavi.dispatch_ms": 1.5, "cavi.freeze_ms": 0.5, "restarts.boundary_ms": 2.0,
        "restarts.outside_loops_share": 30.0, "kernel.launch_host_us": 10.0}


def _fake(monkeypatch, spans=SPANS, counts=COUNTS, records=RECORDS):
    fake = types.SimpleNamespace(totals=lambda: {"spans": spans, "counts": counts},
                                 spans=lambda full=False: records)
    monkeypatch.setattr(program_trace, "_profiling", lambda: fake)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_on_synthetic_totals(monkeypatch, name):
    _fake(monkeypatch)
    read = spec.load_metric(name)
    assert read({"traced": {"lane_steps": 12000}}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_the_programs_totals(monkeypatch, name):
    read = spec.load_metric(name)
    run = {"traced": {"lane_steps": 12000}}
    assert read(run) is None  # the tracer recorded nothing
    assert read({}) is None   # not a traced run
    monkeypatch.setattr(program_trace, "_profiling", lambda: None)  # a package without it
    assert read(run) is None
    _fake(monkeypatch)
    assert read({"traced": {"lane_steps": 11999}}) is None  # another count of lane steps
    _fake(monkeypatch, spans={}, counts={})
    assert read(run) is None


@pytest.mark.parametrize("cell", ["tiny_mmctm.api", "tiny_mmctm.cli"])
def test_the_programs_counts_equal_the_harness_wrappers(tiny, tmp_path, cell):
    """A fit of the tiny cell traced by the program alone: its steps, lane
    steps and lane-iterations are those the harness's wrappers count, and
    every new reader but the kernels' (no kernel runs on the CPU) reads."""
    bench, base = tiny
    r = spec.resolve(bench, cell, base=base)
    prog = harness.program(r["entry"])
    recorder = Recorder(prog, r["entry"].HOOKS)
    recorder.install()
    try:
        job = r["entry"].Job(prog, r["config"], r["traffic"], corpus.load(r["config"]),
                             str(tmp_path / "out"), "cpu", recorder.span)
        with profiling.tracing():
            assert job.run(harness.fit_seed(2**31 + 11, 0))
    finally:
        recorder.uninstall()
    counts = profiling.totals()["counts"]
    assert counts["loop.steps"] == recorder.steps > 0
    assert counts["loop.lane_steps"] == recorder.lane_steps
    assert counts["loop.lane_iters"] == recorder.lane_iters_needed()
    run = {"traced": {"lane_steps": recorder.lane_steps}}
    for name in NEW:
        value = spec.load_metric(name, base)(run)
        assert (value is None) == (name == "kernel.launch_host_us"), name
    share = spec.load_metric("restarts.outside_loops_share", base)(run)
    assert 0 < share < 100


class _Event:
    def __init__(self, start, end):
        self._s, self._e = start, end

    def device_type(self):
        return "DeviceType.CUDA"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def name(self):
        return "kernel"


def test_an_idle_gap_is_charged_to_the_programs_innermost_span(monkeypatch):
    ticks = iter([0, 100, 150, 250, 400, 500])
    monkeypatch.setattr(profiling, "_time_ns", lambda: next(ticks))
    with profiling.tracing():
        with profiling.entry("restarts.fit"):        # 0 .. 500
            run = profiling.begin("loop.run")        # 100 .. 400
            step = profiling.begin("step")           # 150 .. 350
            profiling.begin("step.estep")            # 250 .. 350
            profiling.end(step, 350)
            profiling.end(run)
    got = trace.summarize([_Event(0, 200), _Event(300, 500)], profiling.spans(), 0, 500)
    # the gap 200..300 starts inside `step`, before step.estep opens
    assert got["idle_gaps"] == [["step", pytest.approx(100e-9)]]
    assert got["busy_s"] == pytest.approx(400e-9)
