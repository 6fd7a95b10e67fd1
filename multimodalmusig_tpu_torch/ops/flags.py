"""Environment flags of the port, read once at import.

Counterpart of multimodalmusig_tpu/ops/flags.py, of which it keeps the one
flag that changes what a fit computes here. The others are TPU kernel gates,
A/B switches or select a re-score executor this package does not have.
Tests flip a flag by monkeypatching the module constant: its readers look it
up at call time.
"""

import os

# MUSIG_F32_FULL_BUDGETS=1: float32 fits run the solvers' cold-start budgets
# instead of the warm-start caps (LAMBDA_NITER_F32_CAVI etc., ops/solvers.py)
# that were tuned on BRCA and PCAWG; for data with harsher precision-matrix
# geometry (models/ctm_base.resolved_budgets).
F32_FULL_BUDGETS = os.environ.get("MUSIG_F32_FULL_BUDGETS", "0") == "1"
