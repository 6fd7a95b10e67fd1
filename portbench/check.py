"""The comparison that decides `correct`, and its control.

Every number compares what the timed path produced with the plain
reference (portbench/reference.py), run in float64 on the fits sampled
from the seed:
  * `eta`, `theta`, `mstep`, `step_ll`: two early CAVI steps and the last
    step of every `mmctm.fit` call of a sampled fit (each phase: stage 1,
    or the pilot and the compacted rest, and stage 2), on a few lanes drawn
    from the seed, recomputed from the captured input state
    (`step_components`): the relative Frobenius gap, worst lane, of ζ, ν
    and λ (the η kernel; λ where `holds_lambda` says); of sumθ and each
    scatter (the θ kernel); of μ, Σ and γ (the M-step); and the relative
    gap of the step's lls;
  * `rescore`: the program's float64 scores of the stage-1 lanes it
    shortlisted, against the reference's scores of their final states;
  * `pick`: how far the program's stage-1 winner of each modality lies
    below the best reference score over every stage-1 lane: an exact
    comparison (limit 0);
  * `model_ll`: the selected model's reported lls against the reference's
    lls of its state;
  * `outputs` (the CLI): the largest difference of a written signature
    or proportion from the reference's, from the selected state.
The control is the reference put in the program's place one precision
below the program's: the steps and the model's lls in float32 with TF32
products (the program's float32 runs with TF32 off), the scores in
float32 (the program's are float64), the written tables, which the
program forms elementwise in float32, in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

NUMBERS = ("eta", "theta", "mstep", "step_ll", "rescore", "pick", "model_ll", "outputs")


def required(entry):
    """The numbers that every run of a cell whose traffic calls `entry`
    has to read: all, and the written tables only where the CLI writes
    them. A required number that a run did not read fails it."""
    return tuple(n for n in NUMBERS if n != "outputs" or entry == "cli")


def rel(a, b):
    """Worst lane's ‖a − b‖ / ‖b‖ over (R, ...) tensors."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


def ll_gap(a, b):
    """Largest |a − b| / |b| over the entries."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    return float(((a - b).abs() / b.abs()).max())


def _worst(values):
    """The largest of the readings, NaN if any is NaN, None if none."""
    values = [v for v in values if v is not None]
    if not values:
        return None
    if any(not np.isfinite(v) for v in values):
        return float("nan")
    return max(values)


def _as(x, dtype, device):
    if isinstance(x, (list, tuple)):
        return [_as(t, dtype, device) for t in x]
    return torch.as_tensor(x).to(device=device, dtype=dtype)


# The captured steps of every `mmctm.fit` call: one drawn from each range,
# and the last.
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


def _mstep(lam, nu, alpha, scatter):
    """μ, Σ and γ in float64 from an E-step's own λ, ν and scatters."""
    D = lam.shape[1]
    mu = lam.mean(dim=1)
    E = lam - mu[:, None, :]
    Sigma = (torch.diag_embed(nu.sum(dim=1)) + E.mT @ E) / D
    return mu, Sigma, [alpha[:, m, None, None] + s for m, s in enumerate(scatter)]


def step_components(capture, X, K, device, control=False):
    """The gaps of one captured step, by component: the program's outputs
    (or with `control` the reference's in float32 with TF32 products) against
    the float64 reference: ζ, ν, λ, sumθ and the scatters from the step's
    inputs; μ, Σ and γ against the M-step recomputed from the same step's
    own λ, ν and scatters, and the lls against those of its own λ and γ, so
    that each layer is held to its own inputs."""
    X64 = _as(X, torch.float64, device)
    inp64 = {k: _as(v, torch.float64, device) for k, v in capture["inp"].items()}
    r = ref.cavi_step(inp64, X64, K)
    if control:
        inp32 = {k: _as(v, torch.float32, device) for k, v in capture["inp"].items()}
        with ref.tf32_products():
            out = ref.cavi_step(inp32, _as(X, torch.float32, device), K)
    else:
        out = capture["out"]
    out = {k: _as(v, torch.float64, device) for k, v in out.items()}
    mu, Sigma, gamma = _mstep(out["lam"], out["nu"], inp64["alpha"], out["scatter"])
    ll = ref.modality_lls(X64, ref.proportions(out["lam"], K), ref.signatures(out["gamma"]))
    return {
        "zeta": rel(out["zeta"], r["zeta"]), "nu": rel(out["nu"], r["nu"]),
        "lam": rel(out["lam"], r["lam"]), "sumtheta": rel(out["sumtheta"], r["sumtheta"]),
        "scatter": max(rel(a, b) for a, b in zip(out["scatter"], r["scatter"])),
        "mu": rel(out["mu"], mu), "Sigma": rel(out["Sigma"], Sigma),
        "gamma": max(rel(a, b) for a, b in zip(out["gamma"], gamma)),
        "ll": ll_gap(out["ll"], ll),
    }


def phase_captures(sample):
    """[(capture, final)] over the fit's phases, `final` for the last phase's."""
    phases = sample["phases"]
    return [(c, i == len(phases) - 1) for i, p in enumerate(phases) for c in p["captures"]]


def step_numbers(captures, X, K, device, control=False):
    """(eta, theta, mstep, step_ll) over the captured steps of a fit
    ([(capture, final)])."""
    comps = [(holds_lambda(c["t"], final), step_components(c, X, K, device, control))
             for c, final in captures]
    if not comps:
        return None, None, None, None
    eta = _worst([c[k] for _, c in comps for k in ("zeta", "nu")]
                 + [c["lam"] for held, c in comps if held])
    theta = _worst([c[k] for _, c in comps for k in ("sumtheta", "scatter")])
    mstep = _worst([c[k] for _, c in comps for k in ("mu", "Sigma", "gamma")])
    return eta, theta, mstep, _worst([c["ll"] for _, c in comps])


def _finite_rows(ll):
    return torch.isfinite(ll).all(dim=-1)


def fit_numbers(sample, X, K, device, control=False):
    """The numbers of one sampled fit (a dict; a number that the fit has
    nothing for is None)."""
    out = dict.fromkeys(NUMBERS)
    out["eta"], out["theta"], out["mstep"], out["step_ll"] = step_numbers(
        phase_captures(sample), X, K, device, control)

    X64 = _as(X, torch.float64, device)
    s1 = sample["stage1"]
    lam1 = _as(s1["lam"], torch.float64, device)
    gamma1 = _as(s1["gamma"], torch.float64, device)
    ll64 = ref.lls_of_states(lam1, gamma1, X64, K)
    w = sample["winners"]
    lanes = torch.as_tensor(w["lanes"], device=device)
    if control:
        X32 = _as(X, torch.float32, device)
        scores = ref.lls_of_states(lam1.float()[lanes], [g.float()[lanes] for g in gamma1],
                                   X32, K)
    else:
        scores = torch.as_tensor(w["ll_f64"], device=device)
    out["rescore"] = ll_gap(scores, ll64[lanes])
    best = torch.as_tensor(w["best"], device=device)
    masked = torch.where(_finite_rows(ll64)[:, None], ll64, -torch.inf)
    out["pick"] = float((masked.max(dim=0).values
                         - ll64[best, torch.arange(len(K), device=device)]).max())

    m = sample["model"]
    lam = _as(m["lam"], torch.float64, device)[None]
    gamma = [g[None] for g in _as(m["gamma"], torch.float64, device)]
    model_ref = ref.modality_lls(X64, ref.proportions(lam, K), ref.signatures(gamma))[0]
    if control:
        with ref.tf32_products():
            reported = ref.modality_lls(_as(X, torch.float32, device),
                                        ref.proportions(lam.float(), K),
                                        ref.signatures([g.float() for g in gamma]))[0]
    else:
        reported = torch.as_tensor(m["ll"], dtype=torch.float64, device=device)
    out["model_ll"] = ll_gap(reported, model_ref)

    if "tables" in sample:
        props_ref = torch.cat(ref.proportions(lam, K), dim=-1)[0].T      # (MK, D)
        sigs_ref = ref.signatures(gamma)
        if control:
            props = torch.cat(ref.proportions(lam.bfloat16(), K), dim=-1)[0].T
            sigs = ref.signatures([g.bfloat16() for g in gamma])
        else:
            props = _as(sample["tables"]["props"], torch.float64, device)
            sigs = [_as(s, torch.float64, device)[None] for s in sample["tables"]["sigs"]]
        gaps = [float((props.double() - props_ref).abs().max())]
        gaps += [float((a.double() - b).abs().max()) for a, b in zip(sigs, sigs_ref)]
        out["outputs"] = max(gaps)
    return out


def numbers(samples, X, K, device, control=False):
    """Each number's worst reading over the sampled fits."""
    per_fit = [fit_numbers(s, X, K, device, control) for s in samples]
    return {name: _worst([f[name] for f in per_fit]) for name in NUMBERS}


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
