"""The comparison that decides `correct`, and its control.

Every number compares what the timed path produced with a plain
reference, run in float64 on the fits sampled from the seed. Which
numbers a cell reads, and how, its entry says (portbench/entries/<entry>.py:
`fit_numbers` and `REQUIRED`; MMCTM's in portbench/families/mmctm.py,
against portbench/reference.py). Their names are `NUMBERS`, the set a
configuration's `limits` draws on:
  * `eta`, `theta`, `mstep`, `step_ll`: captured CAVI steps, recomputed
    from their input state: the η side (ζ, ν, λ), the θ moments, the
    M-step and γ, the step's lls;
  * `rescore`, `pick`: the selection's float64 scores and the lane it
    picked;
  * `model_ll`: the selected model's reported lls;
  * `outputs`: the tables a CLI writes.
The control is the reference put in the program's place one precision
below the program's (`control=True` of `fit_numbers`): float32 with TF32
products where the program runs float32 with TF32 off, float32 where it
runs float64, bfloat16 for tables it forms elementwise in float32.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("eta", "theta", "mstep", "step_ll", "rescore", "pick", "model_ll", "outputs")


def required(entry):
    """The numbers that every run of a cell whose traffic calls `entry` (its
    loaded module) has to read: the entry's `REQUIRED`, each one of
    `NUMBERS`. A required number that a run did not read fails it."""
    names = tuple(entry.REQUIRED)
    unknown = sorted(set(names) - set(NUMBERS))
    if unknown:
        raise ValueError(f"required numbers {unknown} are not among check.NUMBERS")
    return names


def rel(a, b):
    """Worst lane's ‖a − b‖ / ‖b‖ over (R, ...) tensors."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


def ll_gap(a, b):
    """Largest |a − b| / |b| over the entries."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    return float(((a - b).abs() / b.abs()).max())


def worst(values):
    """The largest of the readings, NaN if any is NaN, None if none."""
    values = [v for v in values if v is not None]
    if not values:
        return None
    if any(not np.isfinite(v) for v in values):
        return float("nan")
    return max(values)


def as_dtype(x, dtype, device):
    if isinstance(x, (list, tuple)):
        return [as_dtype(t, dtype, device) for t in x]
    return torch.as_tensor(x).to(device=device, dtype=dtype)


# The captured steps of every `fit` call of the model module: one drawn from
# each range, and the last.
CAPTURE_STEPS = ((1, 3), (3, 8))
LAMBDA_STEPS = (1, 3)


def holds_lambda(t, final):
    """Whether λ of step t of a fit phase is held to the reference's optimum.
    The program's fixed-budget solve (3 Newton steps of 4 PCG iterations, 1
    polish) reaches the optimum to rounding at steps 1-2 of every phase, and
    at every step but the first of the final phase (stage 2, which fits the
    selected model from the winners' γ). It stops short of it by as much as
    the control's error at the first step of a phase, which starts its solve
    cold (λ = 0), and from step 3 of the earlier phases, where Σ grows
    ill-conditioned (PERF.md §2, the readings of `readings --every`)."""
    return t >= LAMBDA_STEPS[0] and (final or t < LAMBDA_STEPS[1])


def numbers(entry, samples, X, config, device, control=False):
    """Each number's worst reading over the sampled fits, each fit's read by
    the entry's `fit_numbers(sample, X, config, device, control)` (a dict;
    a number it has nothing for is None or left out)."""
    per_fit = [entry.fit_numbers(s, X, config, device, control) for s in samples]
    return {name: worst([f.get(name) for f in per_fit]) for name in NUMBERS}


def judge(values, limits, required=NUMBERS):
    """(correct, {name: [value, limit]}) over the numbers that the run read
    and those `required`; a required number that the run did not read
    (value None), a number without a limit, or one that is NaN, fails."""
    checks, ok = {}, True
    for name in NUMBERS:
        value = values.get(name)
        if value is None and name not in required:
            continue
        limit = limits.get(name)
        checks[name] = [value, limit]
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, checks
