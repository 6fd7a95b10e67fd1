"""Spans, counters and captures the harness records around the program's
calls, from outside: it replaces module attributes of the program by
wrappers while a run lasts (`Recorder.install`, `Recorder.uninstall`), and
the program looks them up at call time. What it wraps in a family's
program, and what it captures there, the cell's entry names (`Hooks`,
portbench/entries/<entry>.py); the η and θ kernels' wrappers are wrapped
for every family.

Recorded in every run (each a few host operations a CAVI step):
  * the CAVI steps and the restart lanes each step computes (the step
    closures of the model module's `fit_step_fn`), the lane-iterations
    the lanes needed (Σ n_iters of every `fit` of the model module), and
    the time of the fit loops (its `run_cavi`);
  * the time of the restarts function inside each call of the entry point;
  * for the fits sampled for the check (`Recorder.begin_fit`): at one
    step drawn from each range of `capture_steps` and at the last step of
    every `fit` call, the state fields the hooks name of the step's input
    and output, its lls and its θ moments (sumθ and the scatters), on a few
    lanes drawn from the seed; and what the hooks capture of the selection
    functions' and the restarts function's results (for MMCTM: the
    stage-1 winners and the float64 scores they were read from, the
    stage-1 final λ and γ of every lane, the selected model).
Recorded only while `tracing` is on (the profiled fits): a named span on
the profiler's clock around each wrapped call, and the shapes, budgets
and frozen bound (portbench/yardstick.py) of each η and θ kernel call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Mapping, Optional, Tuple

import torch

from . import yardstick
from .check import CAPTURE_STEPS


@dataclasses.dataclass(frozen=True)
class Hooks:
    """What the Recorder wraps in one family's program, and what it
    captures there; an entry's `HOOKS`.

    `model`: the program's attribute (and the spans' prefix, `<model>.fit`)
    of the model module whose `fit`, `fit_step_fn` and `run_cavi` are
    wrapped; `theta`: the model module's attribute that its θ moments go
    through, returning (sumθ, scatters); `lanes(state)`: (lanes, device) of
    a batched state; `restarts`: the function of the program's `restarts`
    module that one call of the entry runs (span `restarts.<restarts>`),
    and `capture_model(model)`: what a sampled fit keeps of its result, a
    dict; `selections`: {name: capture or None}, the restarts module's
    selection functions (span `rescore.<name>`) and what a sampled fit
    keeps of each one's result (`capture(result)`, a dict); `step_inputs`,
    `step_outputs`: the state fields a captured step keeps of its input and
    output state (a tuple field, per modality or per [m][i], as nested
    lists)."""

    model: str
    theta: str
    lanes: Callable
    restarts: str
    capture_model: Callable
    selections: Mapping[str, Optional[Callable]]
    step_inputs: Tuple[str, ...]
    step_outputs: Tuple[str, ...]


def eta_defaults(MK):
    """The η kernel wrapper's budgets for those a caller leaves out: its
    n_iter 7, and the plain solver's cold defaults min(MK, 10), 2 and 8."""
    return {"n_iter": 7, "cg_iter": min(MK, 10), "polish_iter": 2, "nu_n_iter": 8}


def _take(x, idx):
    """`x`'s lanes `idx`: a tensor, or nested tuples of them (as lists)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [_take(t, idx) for t in x]
    return x.index_select(0, idx)


def _cpu(x):
    if isinstance(x, (list, tuple)):
        return [_cpu(t) for t in x]
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    return x


class _Phase:
    """One call of the model module's `fit` in a fit."""

    def __init__(self, capture_at, lane_draws):
        self.capture_at = capture_at  # the step indices to capture
        self.lane_draws = lane_draws  # in [0, 1): the lanes captured besides the ends
        self._index = {}              # batch size -> the captured lanes' index tensor
        self.steps = 0
        self.captures = []
        self.last = None  # the newest step's capture

    def lanes(self, R, device):
        """(positions, index tensor) of the captured lanes in a batch of R:
        the first, the last and the drawn ones; the tensor is made once
        for each batch size."""
        pos = sorted({0, R - 1, *(int(u * R) for u in self.lane_draws)})
        if R not in self._index:
            self._index[R] = torch.as_tensor(pos, device=device)
        return pos, self._index[R]

    def record(self):
        """The phase as the check reads it, its last step marked."""
        caps = list(self.captures)
        if self.last is not None:
            if not any(c is self.last for c in caps):
                caps.append(self.last)
            self.last["last"] = True
        return {"steps": self.steps, "captures": caps}


class Recorder:
    def __init__(self, program, hooks, capture_steps=CAPTURE_STEPS, lanes_captured=4,
                 capture_every=False):
        """`program`: the modules a run drives (portbench/harness.py
        `program`); `hooks`: the entry's `Hooks`. `capture_steps`: ranges
        [lo, hi) of step indices; a sampled fit captures one step drawn from
        each in every `fit` call, or every step of them with
        `capture_every`."""
        self.p = program
        self.hooks = hooks
        self.capture_steps = [tuple(r) for r in capture_steps]
        self.capture_every = capture_every
        self.lanes_captured = int(lanes_captured)
        self.tracing = False
        self._saved = []
        self._fit = None       # the current fit's sample record, or None
        self._phase = None     # the current `fit` call's _Phase, or None
        self._theta_idx = None
        self._theta_out = None
        self.reset()

    # -- counters --------------------------------------------------------
    def reset(self):
        self.steps = 0
        self.lane_steps = 0
        self.loop_s = 0.0
        self.restarts_s = 0.0
        self._needed = []
        self.kernels = {"eta": {"calls": 0, "bound_s": 0.0},
                        "theta": {"calls": 0, "bound_s": 0.0}}
        self.spans = []

    def lane_iters_needed(self):
        return float(sum(int(t) for t in self._needed))

    # -- installing ------------------------------------------------------
    def _patch(self, module, name, make):
        orig = getattr(module, name)
        self._saved.append((module, name, orig))
        setattr(module, name, make(orig))

    def install(self):
        p, h = self.p, self.hooks
        model = getattr(p, h.model)
        self._patch(p.restarts, h.restarts, self._wrap_restarts)
        for name, capture in h.selections.items():
            self._patch(p.restarts, name,
                        lambda orig, n=name, c=capture: self._wrap_selection(orig, n, c))
        self._patch(model, "fit", self._wrap_fit)
        self._patch(model, "fit_step_fn", self._wrap_step_fn)
        self._patch(model, "run_cavi", self._wrap_run_cavi)
        self._patch(model, h.theta, self._wrap_theta_moments)
        self._patch(p.estep_kernel, "estep_eta_fused", self._wrap_eta_kernel)
        self._patch(p.theta_kernel, "theta_moments_fused", self._wrap_theta_kernel)

    def uninstall(self):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self._saved = []

    @contextlib.contextmanager
    def _timed_span(self, name):
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((start, time.time_ns(), name))

    def span(self, name):
        """A named span on the profiler's clock (the system clock, in ns)
        while tracing; nothing otherwise."""
        if self.tracing:
            return self._timed_span(name)
        return contextlib.nullcontext()

    # -- one fit of the entry point ---------------------------------------
    def begin_fit(self, sample_rng):
        """Start a fit; with a numpy Generator it is sampled for the check."""
        self._fit = None if sample_rng is None else {"rng": sample_rng, "phases": []}

    def end_fit(self):
        """The sampled fit's record, moved to the host (None if not sampled)."""
        rec, self._fit = self._fit, None
        if rec is None:
            return None
        rec.pop("rng")
        return _cpu(rec)

    # -- wrappers --------------------------------------------------------
    def _wrap_restarts(self, orig):
        span = f"restarts.{self.hooks.restarts}"

        def restarts(*args, **kwargs):
            t0 = time.perf_counter()
            with self.span(span):
                model = orig(*args, **kwargs)
            self.restarts_s += time.perf_counter() - t0
            if self._fit is not None:
                self._fit.update(self.hooks.capture_model(model))
            return model
        return restarts

    def _wrap_selection(self, orig, name, capture):
        span = f"rescore.{name}"

        def selection(*args, **kwargs):
            with self.span(span):
                result = orig(*args, **kwargs)
            if self._fit is not None and capture is not None:
                self._fit.update(capture(result))
            return result
        return selection

    def _wrap_fit(self, orig):
        fit_span = f"{self.hooks.model}.fit"

        def fit(*args, **kwargs):
            phase = None
            if self._fit is not None:
                rng = self._fit["rng"]
                if self.capture_every:
                    at = {t for lo, hi in self.capture_steps for t in range(lo, hi)}
                else:
                    at = {int(rng.integers(lo, hi)) for lo, hi in self.capture_steps}
                phase = _Phase(at, rng.random(max(0, self.lanes_captured - 2)))
                self._fit["phases"].append(phase)
            self._phase = phase
            with self.span(fit_span):
                result = orig(*args, **kwargs)
            self._needed.append(result.n_iters.sum())
            if phase is not None:
                self._fit["phases"][-1] = phase.record()
            self._phase = None
            return result
        return fit

    def _wrap_run_cavi(self, orig):
        def run_cavi(*args, **kwargs):
            t0 = time.perf_counter()
            with self.span("ctm_base.run_cavi"):
                out = orig(*args, **kwargs)
            self.loop_s += time.perf_counter() - t0
            return out
        return run_cavi

    def _wrap_step_fn(self, orig):
        h = self.hooks

        def fit_step_fn(*args, **kwargs):
            step = orig(*args, **kwargs)
            phase = self._phase

            def wrapped(s):
                R, device = h.lanes(s)
                self.steps += 1
                self.lane_steps += R
                if phase is None:
                    with self.span("cavi.step"):
                        return step(s)
                # a sampled fit: every step is captured, since any may be
                # the last; the drawn steps are kept, and the newest
                t = phase.steps
                phase.steps += 1
                pos, idx = phase.lanes(R, device)
                inp = {k: _take(getattr(s, k), idx) for k in h.step_inputs}
                self._theta_idx = idx
                try:
                    with self.span("cavi.step"):
                        new, ll = step(s)
                finally:
                    self._theta_idx = None
                out = {k: _take(getattr(new, k), idx) for k in h.step_outputs}
                out["ll"] = ll.index_select(0, idx)
                out.update(self._theta_out or {})
                self._theta_out = None
                capture = {"R": R, "t": t, "lanes": pos, "inp": inp, "out": out}
                if t in phase.capture_at:
                    phase.captures.append(capture)
                phase.last = capture
                return new, ll
            return wrapped
        return fit_step_fn

    def _wrap_theta_moments(self, orig):
        def theta_moments(*args, **kwargs):
            sumtheta, scatters = orig(*args, **kwargs)
            idx = self._theta_idx
            if idx is not None:
                self._theta_out = {"sumtheta": _take(sumtheta, idx),
                                   "scatter": _take(scatters, idx)}
            return sumtheta, scatters
        return theta_moments

    def _wrap_eta_kernel(self, orig):
        def estep_eta_fused(lam0, nu, N, sumtheta, mu, invSigma, K, *args, **kwargs):
            if not self.tracing:
                return orig(lam0, nu, N, sumtheta, mu, invSigma, K, *args, **kwargs)
            budgets = eta_defaults(sum(K))
            given = dict(zip(budgets, args))
            given.update({k: v for k, v in kwargs.items() if k in budgets})
            budgets.update({k: v for k, v in given.items() if v is not None})
            lam_prev = kwargs.get("lam_prev") is not None
            k = self.kernels["eta"]
            k["calls"] += 1
            k["bound_s"] += 1e-3 * yardstick.eta_bound(lam0.shape[0], lam0.shape[1], tuple(K),
                                                       lam_prev=lam_prev, **budgets)[0]
            return orig(lam0, nu, N, sumtheta, mu, invSigma, K, *args, **kwargs)
        return estep_eta_fused

    def _wrap_theta_kernel(self, orig):
        def theta_moments_fused(lam_block, logw, X):
            if self.tracing:
                R, D, K = lam_block.shape
                V = X.shape[-1]
                k = self.kernels["theta"]
                k["calls"] += 1
                k["bound_s"] += 1e-3 * yardstick.theta_bound(R, D, V, K)[0]
            return orig(lam_block, logw, X)
        return theta_moments_fused
