"""Worked examples on the port's entry points, each runnable as
`python -m multimodalmusig_tpu_torch.examples.<name>`: `fit_brca` (every
family on the BRCA-EU cohort), `large_scale` (a restart fleet with
pilot-derived compaction, or fanned out over several devices) and
`select_k` (K by held-out log-likelihood)."""
