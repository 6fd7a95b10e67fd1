"""Entry `fit_mmctm_restarts`: one call of the port's best-of-N two-stage
MMCTM fit, `fit_mmctm_restarts(K, alpha, docs, V=V, seed=..., **kwargs)`,
the traffic mix's `kwargs` passed through."""

import numpy as np

from portbench import corpus
from portbench.families import mmctm as family

HOOKS = family.HOOKS
REQUIRED = tuple(n for n in family.NUMBERS if n != "outputs")
fit_numbers = family.fit_numbers
step_components = family.step_components
step_flops_per_lane = family.step_flops_per_lane
program = family.program


class Job:
    """One call of `fit_mmctm_restarts` on the configuration's corpus."""

    def __init__(self, prog, config, traffic, data, outdir, device, span):
        self.p, self.config, self.traffic, self.device = prog, config, traffic, device
        self.docs = corpus.sparse_docs(data["X"])

    def run(self, seed):
        """Fit once; True when every ll of the selected model is finite."""
        c = self.config
        model = self.p.restarts.fit_mmctm_restarts(
            c["K"], c["alpha"], self.docs, V=c["V"], seed=seed, device=self.device,
            **self.traffic.get("kwargs", {}))
        return bool(np.all(np.isfinite(model.ll)))
