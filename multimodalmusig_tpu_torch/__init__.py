"""multimodalmusig_tpu_torch — the MMCTM restart fit in PyTorch, with its
λ Newton/PCG solve as a hand-written CUDA kernel for Hopper (H100).

The port of the JAX package `multimodalmusig_tpu`, which stays as the
reference: the module names are the same, so each counterpart is easy to
find. This package imports `torch` and never `jax` or the JAX package.

Entry points:
  * `fit_restarts(seed, X, config, alpha, restarts, ..., device="cuda")` —
    best-of-N restarts as one batch (parallel/restarts.py);
  * `MMCTM(k, alpha, X, device=...)` and `.fit()` — one model with the
    reference's field surface (models/mmctm.py).
"""

from .interop import state_from_numpy
from .models.mmctm import (
    MMCTM,
    MMCTMConfig,
    MMCTMFitResult,
    MMCTMState,
    fit,
    init_with_alpha,
)
from .ops import lambda_kernel
from .parallel.restarts import (
    fit_restarts,
    fit_restarts_from_states,
    lane,
    pick_optimal_modality_restarts,
    pick_optimal_restart,
)
from .utils.data import brca_counts_path, brca_data_dir
from .utils.fast_tsv import read_counts_tsv
from .utils.formatting import (
    dense_to_sparse,
    format_counts_ctm,
    format_counts_lda,
    format_counts_mmctm,
    make_count_matrix,
    sparse_to_dense,
)

__all__ = [
    "MMCTM",
    "MMCTMConfig",
    "MMCTMFitResult",
    "MMCTMState",
    "fit",
    "init_with_alpha",
    "fit_restarts",
    "fit_restarts_from_states",
    "lane",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "state_from_numpy",
    "lambda_kernel",
    "brca_counts_path",
    "brca_data_dir",
    "read_counts_tsv",
    "dense_to_sparse",
    "format_counts_ctm",
    "format_counts_lda",
    "format_counts_mmctm",
    "make_count_matrix",
    "sparse_to_dense",
]
