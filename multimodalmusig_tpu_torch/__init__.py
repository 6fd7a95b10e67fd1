"""multimodalmusig_tpu_torch — the LDA, ILDA, MMCTM and IMMCTM fits in
PyTorch, with the fused η side of the E-step (ζ, ν and the λ Newton/PCG
solve), the λ solve alone and the θ moments as hand-written CUDA kernels for
Hopper (H100); the θ-moments kernel is also the LDA and ILDA E-step.

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
  * `fit_lda_restarts(k, alpha, eta, X, restarts, ...)` and
    `fit_ilda_restarts(k, alpha, eta, features, X, restarts, ...)` —
    best-of-N LDA and ILDA with f64 re-scored picks (parallel/restarts.py);
    `LDA(k, alpha, eta, X)` and `ILDA(k, alpha, eta, features, X)` and
    `.fit()` — one model (models/lda.py, models/ilda.py);
  * `python -m multimodalmusig_tpu_torch.cli` (`run-mmctm-torch`) — the
    reference CLI on count TSVs, with checkpoints (`save_model`,
    `load_model`) and TSV outputs (utils/io.py);
  * inference with a fitted or loaded model, on its device: `transform(model,
    X)`, `fit_heldout(Xheldout, model)` and `predict_modality_eta(Xobs, m,
    model)` (1-based m; the CTM families only), dispatched to the model's
    module as the reference's multiple dispatch does, with `calculate_elbo`,
    `calculate_loglikelihood` (LDA, ILDA), `calculate_loglikelihoods` and
    `calculate_docmodality_loglikelihoods` (MMCTM, IMMCTM);
  * `select_k_mmctm(k_values, X, alpha, ...)` — K by held-out
    log-likelihood (model_selection.py).

The fits can be cut at boundaries: `chunk_iters`, a `compact_schedule`
tuple, or `compact_schedule="auto"`, which `fit_restarts_auto` derives from
a timed pilot and a boundary cost measured on the device
(`measure_boundary_seconds`, `auto_compact_schedule`).
"""

import torch

from .interop import (
    ilda_from_state,
    ilda_state_from_numpy,
    immctm_from_state,
    immctm_state_from_numpy,
    lda_from_state,
    lda_state_from_numpy,
    mmctm_from_state,
    state_from_numpy,
)
from .model_selection import heldout_ll_curve, select_k_mmctm, train_test_split_docs
from .models import ilda as _ilda, immctm as _immctm, lda as _lda, mmctm as _mmctm
from .models.ctm_base import counts_per_doc as _counts_per_doc, full_f32_matmuls as _full_f32
from .models.ilda import ILDA, ILDAConfig, ILDAState
from .models.immctm import IMMCTM, IMMCTMConfig, IMMCTMFitResult, IMMCTMState
from .models.lda import LDA, LDAConfig, LDAFitResult, LDAState
from .models.mmctm import (
    CTM,
    MMCTM,
    MMCTMConfig,
    MMCTMFitResult,
    MMCTMState,
    fit,
    init_with_alpha,
)
from .ops import estep_kernel, lambda_kernel, theta_kernel
from .parallel.rescore import (
    rescore_ilda_f64,
    rescore_immctm_f64,
    rescore_lda_f64,
    rescore_mmctm_f64,
)
from .parallel.restarts import (
    auto_compact_schedule,
    fit_ilda_restarts,
    fit_ilda_restarts_from_states,
    fit_immctm_restarts,
    fit_immctm_restarts_from_states,
    fit_lda_restarts,
    fit_lda_restarts_from_states,
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

# The reference's Project.toml:4 version, as the JAX package's __version__.
__version__ = "0.3.0"

__all__ = [
    "CTM",
    "LDA",
    "LDAConfig",
    "LDAFitResult",
    "LDAState",
    "ILDA",
    "ILDAConfig",
    "ILDAState",
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
    "fit_lda_restarts",
    "fit_lda_restarts_from_states",
    "fit_ilda_restarts",
    "fit_ilda_restarts_from_states",
    "fit_mmctm_restarts",
    "two_stage_fit",
    "two_stage_fit_from_states",
    "select_modality_winners_f64",
    "select_best_restart_f64",
    "suggest_compact_schedule",
    "rescore_mmctm_f64",
    "rescore_immctm_f64",
    "rescore_lda_f64",
    "rescore_ilda_f64",
    "lane",
    "pick_optimal_modality_restarts",
    "pick_optimal_restart",
    "state_from_numpy",
    "immctm_state_from_numpy",
    "mmctm_from_state",
    "immctm_from_state",
    "lda_state_from_numpy",
    "ilda_state_from_numpy",
    "lda_from_state",
    "ilda_from_state",
    "transform",
    "fit_heldout",
    "predict_modality_eta",
    "calculate_elbo",
    "calculate_loglikelihood",
    "calculate_loglikelihoods",
    "calculate_docmodality_loglikelihoods",
    "train_test_split_docs",
    "heldout_ll_curve",
    "select_k_mmctm",
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

# The generic functions of the reference (its multiple dispatch on the model
# type), as multimodalmusig_tpu/__init__.py:71-238 has them.

_MODULES = ((IMMCTM, _immctm), (MMCTM, _mmctm), (ILDA, _ilda), (LDA, _lda))


def _module_of(name, model, families=(IMMCTM, MMCTM, ILDA, LDA)):
    """The models/ module of `model`'s family, if `name` serves it; else
    the TypeError of the reference's dispatch."""
    for cls, module in _MODULES:
        if cls in families and isinstance(model, cls):
            return module
    raise TypeError(f"no {name} for {type(model)!r}")


def transform(model, X, **kwargs):
    """`transform(model, X)`, by the model's type."""
    return _module_of("transform", model).transform(model, X, **kwargs)


def fit_heldout(Xheldout, model, **kwargs):
    """`fit_heldout(Xheldout, model)`, by the model's type."""
    return _module_of("fit_heldout", model).fit_heldout(Xheldout, model, **kwargs)


def predict_modality_eta(Xobs, m, model, **kwargs):
    """`predict_modality_η(Xobs, m, model)` (1-based m), by the model's
    type; LDA and ILDA have none."""
    module = _module_of("predict_modality_eta", model, (IMMCTM, MMCTM))
    return module.predict_modality_eta(Xobs, m, model, **kwargs)


def calculate_elbo(model) -> float:
    """ELBO of the model's current variational state (src/LDA.jl:114-172,
    src/ILDA.jl:132-207, src/MMCTM.jl:372-382, src/IMMCTM.jl:247-360)."""
    module = _module_of("calculate_elbo", model)
    with _full_f32():
        if module is _immctm:
            elbo = _immctm.calculate_elbo(model.state, model.Xdense, _counts_per_doc(model.Xdense),
                                          model.F, model.config)
        elif module is _mmctm:
            elbo = _mmctm.calculate_elbo(model.state, model.Xdense, _counts_per_doc(model.Xdense),
                                         model.config)
        elif module is _ilda:
            elbo = _ilda.calculate_elbo(model.state, model.Xdense, model.F, model.config)
        else:
            elbo = _lda.calculate_elbo(model.state, model.Xdense, model.config)
    return float(elbo[0])


def calculate_loglikelihood(*args) -> float:
    """LDA/ILDA per-word log-likelihood: `calculate_loglikelihood(model)` or
    `(X, model)`, X a list of (n, 2) count matrices (src/LDA.jl:174-196,
    src/ILDA.jl:209-236)."""
    model = args[-1]
    module = _module_of("calculate_loglikelihood", model, (ILDA, LDA))
    Xd = (model.Xdense if len(args) == 1
          else _lda.counts_tensor(sparse_to_dense(args[0], model.V), model.config, model.device))
    theta = _lda.theta_point(model.state)
    with _full_f32():
        if module is _ilda:
            ll = _ilda.loglikelihood(Xd, theta, _ilda.beta_point(model.state), model.F)
        else:
            ll = _lda.loglikelihood(Xd, theta, _lda.beta_point(model.state))
    return float(ll[0])


def _counts_and_model(args, name):
    """(dense counts, model) of `(model)` or `(X, model)`: the model's own
    counts, or X[doc][modality] made dense on the model's device."""
    model = args[-1]
    _module_of(name, model, (IMMCTM, MMCTM))
    if len(args) == 1:
        return model.Xdense, model
    X = args[0]
    dense = [sparse_to_dense([doc[m] for doc in X], model.V[m]) for m in range(model.M)]
    return _mmctm.counts_tensors(dense, model.config, model.device), model


def _loglikelihoods(per_doc, args, name):
    Xd, model = _counts_and_model(args, name)
    with _full_f32():
        if isinstance(model, IMMCTM):
            fn = _immctm.docmodality_loglikelihoods if per_doc else _immctm.modality_loglikelihoods
            return fn(Xd, model.state.lam, model.state.gamma, model.F, model.config)[0]
        fn = _mmctm.docmodality_loglikelihoods if per_doc else _mmctm.modality_loglikelihoods
        return fn(Xd, _mmctm.props_from(model.state.lam, model.config),
                  _mmctm.phi_point(model.state.gamma))[0]


def calculate_loglikelihoods(*args):
    """Per-modality per-word log-likelihoods as a list of floats:
    `calculate_loglikelihoods(model)` or `(X, model)` (src/MMCTM.jl:384-448,
    src/IMMCTM.jl:388-428)."""
    return [float(v) for v in _loglikelihoods(False, args, "calculate_loglikelihoods").cpu()]


def calculate_docmodality_loglikelihoods(*args):
    """Per-document per-modality normalized log-likelihoods as a (D, M)
    float64 array: `(model)` or `(X, model)` (src/MMCTM.jl:384-401,
    src/IMMCTM.jl:362-386); NaN where a document has no counts in a
    modality, the reference's division by N_d = 0."""
    ll = _loglikelihoods(True, args, "calculate_docmodality_loglikelihoods")
    return ll.cpu().to(torch.float64).numpy()
