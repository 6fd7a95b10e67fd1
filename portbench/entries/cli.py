"""Entry `cli`: one in-process call of the port's CLI, `cli.main(argv)`,
on the configuration's count TSVs, writing the signatures and proportions
tables, with the traffic mix's `argv` added. Its check reads the written
tables too (`outputs`)."""

import os

import numpy as np

from portbench import corpus
from portbench.families import mmctm as family

HOOKS = family.HOOKS
REQUIRED = family.NUMBERS
fit_numbers = family.fit_numbers
step_components = family.step_components
step_flops_per_lane = family.step_flops_per_lane


def program():
    from multimodalmusig_tpu_torch import cli
    return dict(family.program(), cli=cli)


class Job:
    """One call of `cli.main` on the configuration's corpus, written as
    TSVs under `outdir` where it has none of its own."""

    def __init__(self, prog, config, traffic, data, outdir, device, span):
        self.p, self.config, self.traffic, self.data = prog, config, traffic, data
        self.device, self.span = device, span
        corpus.write_tsvs(data, config, os.path.join(outdir, "counts"))
        os.makedirs(outdir, exist_ok=True)
        self.tables = {k: os.path.join(outdir, f"{k}.tsv") for k in ("sigs", "props")}

    def run(self, seed):
        """Run the CLI once; True when it exits 0."""
        c = self.config
        argv = [*self.data["tsv"], "-k", *map(str, c["K"]), "-m", *c["modalities"],
                "--alpha", str(c["alpha"][0]), *self.traffic.get("argv", []),
                "--sigs", self.tables["sigs"], "--props", self.tables["props"],
                "--seed", str(seed), "--device", "cuda" if self.device == "cuda" else "cpu"]
        with self.span("cli.main"):
            return self.p.cli.main(argv) == 0

    def read_tables(self):
        """The CLI's written signatures [(K_m, V_m)] and proportions (MK, D)."""
        c = self.config
        sigs = [np.zeros((k, v)) for k, v in zip(c["K"], c["V"])]
        mods = {name: m for m, name in enumerate(c["modalities"])}
        with open(self.tables["sigs"]) as f:
            next(f)
            for line in f:
                mod, topic, value, _, prob = line.rstrip("\n").split("\t")
                sigs[mods[mod]][int(topic) - 1, int(value) - 1] = float(prob)
        with open(self.tables["props"]) as f:
            next(f)
            props = np.array([[float(x) for x in line.rstrip("\n").split("\t")[1:]]
                              for line in f])
        return {"sigs": sigs, "props": props}
