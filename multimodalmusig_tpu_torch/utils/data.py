"""Locator for the bundled BRCA-EU dataset.

A copy of multimodalmusig_tpu/utils/data.py, so the PyTorch package imports
without JAX. The repository bundles the reference's two BSD-2-licensed TSVs
(`data/brca-eu_snv_counts.tsv`, 96 SNV terms x 560 samples, and
`data/brca-eu_sv_counts.tsv`, 48 SV terms) under `data/` at its root.
"""

from __future__ import annotations

import os

__all__ = ["brca_data_dir", "brca_counts_path", "BRCA_FILES"]

BRCA_FILES = ("brca-eu_snv_counts.tsv", "brca-eu_sv_counts.tsv")

# <repo>/multimodalmusig_tpu_torch/utils/data.py -> <repo>/data
_REPO_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data",
)


def brca_data_dir() -> str:
    """Directory holding the BRCA-EU count TSVs: `MUSIG_DATA_DIR` when it
    holds them, else the in-repo `data/` bundle (returned even when missing,
    so callers get a clean FileNotFoundError naming the expected place)."""
    cand = os.environ.get("MUSIG_DATA_DIR")
    if cand and os.path.isfile(os.path.join(cand, BRCA_FILES[0])):
        return cand
    return _REPO_DATA


def brca_counts_path(name: str) -> str:
    """Full path of one bundled TSV (e.g. 'brca-eu_snv_counts.tsv')."""
    return os.path.join(brca_data_dir(), name)
