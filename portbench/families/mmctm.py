"""The MMCTM family as the benchmark drives it, shared by the entries
`fit_mmctm_restarts` and `cli` (portbench/entries/): the program's modules,
the Recorder's hooks and captures, the check's numbers against the float64
reference (portbench/reference.py), and a CAVI step's operations.

The numbers of a sampled fit (`fit_numbers`):
  * `eta`, `theta`, `mstep`, `step_ll`: two early CAVI steps and the last
    step of every `mmctm.fit` call of a sampled fit (each phase: stage 1,
    or the pilot and the compacted rest, and stage 2), on a few lanes drawn
    from the seed, recomputed from the captured input state
    (`step_components`): the relative Frobenius gap, worst lane, of ζ, ν
    and λ (the η kernel; λ where `check.holds_lambda` says); of sumθ and
    each scatter (the θ kernel); of μ, Σ and γ (the M-step); and the
    relative gap of the step's lls;
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

from .. import reference as ref
from .. import yardstick
from ..check import NUMBERS, as_dtype, holds_lambda, ll_gap, rel, worst
from ..instrument import Hooks


def program():
    """The program's modules an MMCTM fit runs through: its restarts and
    its model module."""
    from multimodalmusig_tpu_torch.models import mmctm
    from multimodalmusig_tpu_torch.parallel import restarts
    return {"mmctm": mmctm, "restarts": restarts}


def capture_model(model):
    """The selected model (its lls, λ and γ) and the stage-1 final λ and γ
    of every lane, from `fit_mmctm_restarts`'s result."""
    stage1 = model.restart_result.state
    return {"model": {"ll": [float(v) for v in model.ll], "lam": model.state.lam[0],
                      "gamma": [g[0] for g in model.state.gamma]},
            "stage1": {"lam": stage1.lam, "gamma": list(stage1.gamma)}}


def capture_winners(result):
    """The stage-1 winners and the float64 scores they were read from, from
    `select_modality_winners_f64`'s result."""
    best_m, info = result
    return {"winners": {"best": np.asarray(best_m).copy(),
                        "lanes": np.asarray(info["rescored_lanes"]).copy(),
                        "ll_f64": np.asarray(info["ll_f64"]).copy()}}


HOOKS = Hooks(
    model="mmctm",
    theta="theta_moments",
    lanes=lambda s: (s.lam.shape[0], s.lam.device),
    restarts="fit_mmctm_restarts",
    capture_model=capture_model,
    selections={"select_modality_winners_f64": capture_winners,
                "select_best_restart_f64": None},
    step_inputs=("lam", "nu", "mu", "invSigma", "alpha", "Elnphi"),
    step_outputs=("zeta", "nu", "lam", "mu", "Sigma", "gamma"),
)


def step_flops_per_lane(config):
    """Operations of one CAVI step of one restart lane
    (`yardstick.step_flops_per_lane` at its frozen budgets)."""
    return yardstick.step_flops_per_lane(config["D"], config["K"], config["V"])


def _mstep(lam, nu, alpha, scatter):
    """μ, Σ and γ in float64 from an E-step's own λ, ν and scatters."""
    D = lam.shape[1]
    mu = lam.mean(dim=1)
    E = lam - mu[:, None, :]
    Sigma = (torch.diag_embed(nu.sum(dim=1)) + E.mT @ E) / D
    return mu, Sigma, [alpha[:, m, None, None] + s for m, s in enumerate(scatter)]


def step_components(capture, X, config, device, control=False):
    """The gaps of one captured step, by component: the program's outputs
    (or with `control` the reference's in float32 with TF32 products) against
    the float64 reference: ζ, ν, λ, sumθ and the scatters from the step's
    inputs; μ, Σ and γ against the M-step recomputed from the same step's
    own λ, ν and scatters, and the lls against those of its own λ and γ, so
    that each layer is held to its own inputs."""
    K = config["K"]
    X64 = as_dtype(X, torch.float64, device)
    inp64 = {k: as_dtype(v, torch.float64, device) for k, v in capture["inp"].items()}
    r = ref.cavi_step(inp64, X64, K)
    if control:
        inp32 = {k: as_dtype(v, torch.float32, device) for k, v in capture["inp"].items()}
        with ref.tf32_products():
            out = ref.cavi_step(inp32, as_dtype(X, torch.float32, device), K)
    else:
        out = capture["out"]
    out = {k: as_dtype(v, torch.float64, device) for k, v in out.items()}
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


def step_numbers(captures, X, config, device, control=False):
    """(eta, theta, mstep, step_ll) over the captured steps of a fit
    ([(capture, final)])."""
    comps = [(holds_lambda(c["t"], final), step_components(c, X, config, device, control))
             for c, final in captures]
    if not comps:
        return None, None, None, None
    eta = worst([c[k] for _, c in comps for k in ("zeta", "nu")]
                 + [c["lam"] for held, c in comps if held])
    theta = worst([c[k] for _, c in comps for k in ("sumtheta", "scatter")])
    mstep = worst([c[k] for _, c in comps for k in ("mu", "Sigma", "gamma")])
    return eta, theta, mstep, worst([c["ll"] for _, c in comps])


def _finite_rows(ll):
    return torch.isfinite(ll).all(dim=-1)


def fit_numbers(sample, X, config, device, control=False):
    """The numbers of one sampled fit (a dict; a number that the fit has
    nothing for is None)."""
    K = config["K"]
    out = dict.fromkeys(NUMBERS)
    out["eta"], out["theta"], out["mstep"], out["step_ll"] = step_numbers(
        phase_captures(sample), X, config, device, control)

    X64 = as_dtype(X, torch.float64, device)
    s1 = sample["stage1"]
    lam1 = as_dtype(s1["lam"], torch.float64, device)
    gamma1 = as_dtype(s1["gamma"], torch.float64, device)
    ll64 = ref.lls_of_states(lam1, gamma1, X64, K)
    w = sample["winners"]
    lanes = torch.as_tensor(w["lanes"], device=device)
    if control:
        X32 = as_dtype(X, torch.float32, device)
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
    lam = as_dtype(m["lam"], torch.float64, device)[None]
    gamma = [g[None] for g in as_dtype(m["gamma"], torch.float64, device)]
    model_ref = ref.modality_lls(X64, ref.proportions(lam, K), ref.signatures(gamma))[0]
    if control:
        with ref.tf32_products():
            reported = ref.modality_lls(as_dtype(X, torch.float32, device),
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
            props = as_dtype(sample["tables"]["props"], torch.float64, device)
            sigs = [as_dtype(s, torch.float64, device)[None] for s in sample["tables"]["sigs"]]
        gaps = [float((props.double() - props_ref).abs().max())]
        gaps += [float((a.double() - b).abs().max()) for a, b in zip(sigs, sigs_ref)]
        out["outputs"] = max(gaps)
    return out
