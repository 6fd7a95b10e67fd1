"""multimodalmusig_tpu_torch — the MMCTM and IMMCTM restart fits in PyTorch,
with the fused η side of the E-step (ζ, ν and the λ Newton/PCG solve), the
λ solve alone and the θ moments as hand-written CUDA kernels for Hopper
(H100).

The port of the JAX package `multimodalmusig_tpu`, which stays as the
reference: the module names are the same, so each counterpart is easy to
find. This package imports `torch` and never `jax` or the JAX package.

Entry points, each on the CUDA card unless the caller passes
device="cpu" (without a card they raise):
  * `fit_mmctm_restarts(k, alpha, X, restarts=100, ...)` — the reference
    CLI's two-stage best-of-N MMCTM fit with f64 re-scored picks
    (parallel/restarts.py; `two_stage_fit` is its engine);
  * `fit_restarts(seed, X, config, alpha, restarts, ...,
    compact_schedule=None)` — best-of-N restarts as one batch, optionally
    with straggler compaction (parallel/restarts.py);
  * `MMCTM(k, alpha, X)` and `.fit()` — one model with the reference's
    field surface (models/mmctm.py);
  * `fit_immctm_restarts(k, alpha, features, X, restarts, ...)` —
    best-of-N IMMCTM with f64 re-scored selection (parallel/restarts.py);
  * `IMMCTM(k, alpha, features, X)` and `.fit()` — one feature-factorized
    model (models/immctm.py);
  * `python -m multimodalmusig_tpu_torch.cli` (`run-mmctm-torch`) — the
    reference CLI on count TSVs, with checkpoints (`save_model`,
    `load_model`) and TSV outputs (utils/io.py).

The fits can be cut at boundaries: `chunk_iters`, a `compact_schedule`
tuple, or `compact_schedule="auto"`, which `fit_restarts_auto` derives from
a timed pilot and a boundary cost measured on the device
(`measure_boundary_seconds`, `auto_compact_schedule`).
"""

from .interop import immctm_state_from_numpy, state_from_numpy
from .models.immctm import IMMCTM, IMMCTMConfig, IMMCTMFitResult, IMMCTMState
from .models.mmctm import (
    MMCTM,
    MMCTMConfig,
    MMCTMFitResult,
    MMCTMState,
    fit,
    init_with_alpha,
)
from .ops import estep_kernel, lambda_kernel, theta_kernel
from .parallel.rescore import rescore_immctm_f64, rescore_mmctm_f64
from .parallel.restarts import (
    auto_compact_schedule,
    fit_immctm_restarts,
    fit_immctm_restarts_from_states,
    fit_mmctm_restarts,
    fit_restarts,
    fit_restarts_auto,
    fit_restarts_from_states,
    lane,
    measure_boundary_seconds,
    pick_optimal_modality_restarts,
    pick_optimal_restart,
    select_best_restart_f64,
    select_modality_winners_f64,
    suggest_compact_schedule,
    two_stage_fit,
    two_stage_fit_from_states,
)
from .utils import io
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
from .utils.io import load_model, save_model

__all__ = [
    "IMMCTM",
    "IMMCTMConfig",
    "IMMCTMFitResult",
    "IMMCTMState",
    "MMCTM",
    "MMCTMConfig",
    "MMCTMFitResult",
    "MMCTMState",
    "fit",
    "init_with_alpha",
    "fit_restarts",
    "fit_restarts_from_states",
    "fit_restarts_auto",
    "auto_compact_schedule",
    "measure_boundary_seconds",
    "fit_immctm_restarts",
    "fit_immctm_restarts_from_states",
    "fit_mmctm_restarts",
    "two_stage_fit",
    "two_stage_fit_from_states",
    "select_modality_winners_f64",
    "select_best_restart_f64",
    "suggest_compact_schedule",
    "rescore_mmctm_f64",
    "rescore_immctm_f64",
    "lane",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "state_from_numpy",
    "immctm_state_from_numpy",
    "estep_kernel",
    "lambda_kernel",
    "theta_kernel",
    "io",
    "save_model",
    "load_model",
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
