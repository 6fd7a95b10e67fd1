"""The readers of the program's own spans and counters
(portbench/program_trace.py and the metrics that read it): on synthetic
totals, on nothing, on a lane-step mismatch, on the profiled set alone, and
on a tiny CPU run traced by the program itself, whose counts must equal
those of the harness's wrappers; a tiny `--trace 1` run whose host-span
readers read the set of traced fits that the profiler did not slow; and
the trace's summary charging each idle gap to the innermost span, the
program's or the harness's."""

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


def _run(lane_steps, which="unprofiled"):
    """A traced run's record whose set `which` holds what the program's
    tracer holds now, the harness having counted `lane_steps`."""
    return {"program": {which: program_trace.snapshot(lane_steps)}}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_on_synthetic_totals(monkeypatch, name):
    _fake(monkeypatch)
    read = spec.load_metric(name)
    assert read(_run(12000)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_nothing_without_the_programs_totals(monkeypatch, name):
    read = spec.load_metric(name)
    assert read(_run(12000)) is None  # the tracer recorded nothing
    assert read({}) is None   # not a traced run
    monkeypatch.setattr(program_trace, "_profiling", lambda: None)  # a package without it
    assert read(_run(12000)) is None
    _fake(monkeypatch)
    assert read(_run(11999)) is None  # another count of lane steps
    assert read(_run(12000, "profiled")) is None  # the profiled set alone
    _fake(monkeypatch, spans={}, counts={})
    assert read(_run(12000)) is None


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
    run = _run(recorder.lane_steps)
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


def test_a_traced_run_reads_the_host_spans_from_the_fits_the_profiler_did_not_slow(
        tiny, monkeypatch):
    """A tiny `--trace 1` run traces its fits twice, on the same seeds: the
    host-span readers read the first set, the program's tracer alone, and
    read nothing where that set's lane steps disagree with the harness's
    count, whatever the profiled set holds."""
    bench, base = tiny
    kept = {}
    traced_fits = harness._traced_fits

    def spy(prog, recorder, job, seed, traffic, device, run):
        kept["run"] = run
        return traced_fits(prog, recorder, job, seed, traffic, device, run)

    monkeypatch.setattr(harness, "_traced_fits", spy)
    result = harness.run_cell(spec.resolve(bench, "tiny_mmctm.cli", base=base), 2**31 + 29,
                              0.0, 1, device="cpu")
    assert result["correct"], result["checks"]
    run = kept["run"]
    unprofiled, profiled = run["program"]["unprofiled"], run["program"]["profiled"]
    assert unprofiled["lane_steps"] == profiled["lane_steps"] == run["traced"]["lane_steps"] > 0
    assert unprofiled["totals"]["counts"]["loop.steps"] == profiled["totals"]["counts"][
        "loop.steps"]
    for name in NEW:
        read = spec.load_metric(name, base)
        value = result["metrics"].get(name, {}).get("value")
        assert (value is None) == (name == "kernel.launch_host_us"), name
        assert value == read({"program": {"unprofiled": unprofiled}}), name
        assert read({"program": {"profiled": profiled}}) is None, name
    run["program"]["unprofiled"] = dict(unprofiled, lane_steps=unprofiled["lane_steps"] + 1)
    for name in NEW:
        assert spec.load_metric(name, base)(run) is None, name


# one clock, ns: a harness fit and its wrapped step; inside the step the
# program's `step` and its `step.tail`; the card idle at 200-300 (inside
# `step`), 500-600 (inside `step.tail`) and 880-950 (after `step` closed,
# inside `cavi.step`)
HARNESS = [(100, 900, "cavi.step"), (0, 1000, "portbench.fit")]
PROGRAM = [{"name": "step", "start_ns": 150, "end_ns": 850, "parent": -1, "entry": 1},
           {"name": "step.tail", "start_ns": 400, "end_ns": 800, "parent": 0, "entry": 1}]
BUSY = [_Event(0, 200), _Event(300, 500), _Event(600, 880), _Event(950, 1000)]


def _idle(got):
    return dict((name, round(s * 1e9)) for name, s in got["idle_gaps"])


def test_a_gap_inside_a_program_span_is_charged_to_it():
    got = trace.summarize(BUSY, HARNESS, 0, 1000, program=PROGRAM)
    assert _idle(got)["step"] == 100 and _idle(got)["step.tail"] == 100


def test_a_gap_where_no_program_span_is_open_goes_to_the_harness_span():
    got = trace.summarize(BUSY, HARNESS, 0, 1000, program=PROGRAM)
    assert _idle(got) == {"step": 100, "step.tail": 100, "cavi.step": 70}
    # a program span of no length, closed where it opened, is open nowhere
    instant = {"name": "loop.sync", "start_ns": 860, "end_ns": 860, "parent": -1, "entry": 1}
    got = trace.summarize(BUSY, HARNESS, 0, 1000, program=PROGRAM + [instant])
    assert _idle(got) == {"step": 100, "step.tail": 100, "cavi.step": 70}
    assert sum(s for _, s in got["idle_gaps"]) == pytest.approx(got["window_s"] - got["busy_s"])


def test_without_program_records_the_summary_is_the_harness_spans_alone():
    kernel_s = 0.0
    for ev in BUSY:
        kernel_s += (ev.end_ns() - ev.start_ns()) * 1e-9
    want = {"busy_s": 730 * 1e-9, "window_s": 1000 * 1e-9, "first_device_s": 0.0,
            "eta": [0, 0], "theta": [0, 0], "device_ops": [["kernel", kernel_s]],
            "idle_gaps": [["cavi.step", 0.0 + 100 * 1e-9 + 100 * 1e-9 + 70 * 1e-9]]}
    assert trace.summarize(BUSY, HARNESS, 0, 1000) == want
    assert trace.summarize(BUSY, HARNESS, 0, 1000, program=[]) == want


def test_idle_gaps_past_ten_spans_keep_the_whole_idle_time():
    """Twelve program spans, each with an idle gap of its own length: nine
    by name and the rest together, summing to the idle time."""
    program = [{"name": f"s{i}", "start_ns": 100 * i, "end_ns": 100 * i + 50, "parent": -1,
                "entry": 1} for i in range(12)]
    busy = [_Event(100 * i + 10 + i, 100 * i + 100) for i in range(12)]
    got = trace.summarize(busy, [(0, 1200, "portbench.fit")], 0, 1200, program=program)
    assert [n for n, _ in got["idle_gaps"]] == [f"s{i}" for i in range(11, 2, -1)] + [
        "other spans"]
    assert got["idle_gaps"][-1][1] == pytest.approx((10 + 11 + 12) * 1e-9)
    assert sum(s for _, s in got["idle_gaps"]) == pytest.approx(got["window_s"] - got["busy_s"])
