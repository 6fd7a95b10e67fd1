"""Moving states of every family from the JAX package into this one.

`jax.random` and torch generators never draw the same numbers, so the
parity tests hand the JAX package's initial state to this package through
`state_from_numpy` / `immctm_state_from_numpy` / `lda_state_from_numpy` /
`ilda_state_from_numpy` instead of re-seeding, and a trained state into the
wrappers through `mmctm_from_state` / `immctm_from_state` /
`lda_from_state` / `ilda_from_state`, so both packages run inference on one
trained model. The functions take plain arrays (they import neither JAX nor
the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ctm_base import check_device, lanes_of
from .models.ilda import ILDA, ILDAState
from .models.immctm import IMMCTM, IMMCTMState
from .models.lda import LDA, LDAState
from .models.mmctm import MMCTM, MMCTMState

__all__ = ["state_from_numpy", "immctm_state_from_numpy", "lda_state_from_numpy",
           "ilda_state_from_numpy", "mmctm_from_state", "immctm_from_state", "lda_from_state",
           "ilda_from_state"]

# Tuple depth of each nested field (absent: a plain array).
_MMCTM_DEPTHS = {"gamma": 1, "Elnphi": 1, "logw_pre": 1}
_IMMCTM_DEPTHS = {"alpha": 1, "gamma": 2, "Elnphi": 2, "logw_pre": 1}
_ILDA_DEPTHS = {"lam": 1, "Elnbeta": 1}


def _from_numpy(cls, depths, fields, device, dtype):
    device = check_device(device)
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    # γ is (K_m, V_m) / (K_m, J_mi) / (D, K) per lane in every family
    gamma = fields["gamma"]
    for _ in range(depths.get("gamma", 0)):
        gamma = gamma[0]
    batched = np.ndim(gamma) == 3

    def convert(a, depth):
        if depth:
            return tuple(convert(x, depth - 1) for x in a)
        t = torch.as_tensor(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)
        return t if batched else t.unsqueeze(0)

    return cls(**{name: convert(fields[name], depths.get(name, 0)) for name in cls._fields})


def state_from_numpy(fields, device="cuda", dtype: torch.dtype = torch.float64) -> MMCTMState:
    """An MMCTMState of this package from arrays under the JAX package's
    field names (mu, Sigma, invSigma, alpha, gamma, Elnphi, lam, nu, zeta,
    lam_pre, logw_pre) — a mapping, or any NamedTuple such as the JAX
    MMCTMState itself — unbatched (μ is (MK,)) or with a leading restart
    dimension R (μ is (R, MK)). An unbatched state becomes one lane. On the
    CUDA card unless the caller asks for the CPU (without a card a CUDA
    device raises)."""
    return _from_numpy(MMCTMState, _MMCTM_DEPTHS, fields, device, dtype)


def immctm_state_from_numpy(fields, device="cuda",
                            dtype: torch.dtype = torch.float64) -> IMMCTMState:
    """An IMMCTMState of this package from arrays under the JAX package's
    IMMCTMState field names (α a tuple over modalities, γ/Elnϕ nested
    [m][i], logw_pre a tuple), a mapping or the JAX NamedTuple itself,
    unbatched or with a leading restart dimension R, as `state_from_numpy`."""
    return _from_numpy(IMMCTMState, _IMMCTM_DEPTHS, fields, device, dtype)


def lda_state_from_numpy(fields, device="cuda", dtype: torch.dtype = torch.float64) -> LDAState:
    """An LDAState of this package from arrays under the JAX package's
    LDAState field names (lam, Elnbeta, gamma, Elntheta, Elntheta_pre,
    logw_pre), a mapping or the JAX NamedTuple itself, unbatched (γ is
    (D, K)) or with a leading restart dimension R, as `state_from_numpy`."""
    return _from_numpy(LDAState, {}, fields, device, dtype)


def ilda_state_from_numpy(fields, device="cuda", dtype: torch.dtype = torch.float64) -> ILDAState:
    """An ILDAState of this package from arrays under the JAX package's
    ILDAState field names (λ and Elnβ tuples over the features), unbatched
    or with a leading restart dimension R, as `state_from_numpy`."""
    return _from_numpy(ILDAState, _ILDA_DEPTHS, fields, device, dtype)


def _one_lane(state):
    R = lanes_of(state)[0]
    if R != 1:
        raise ValueError(f"a wrapper holds one lane, the state has {R}")
    return state


def mmctm_from_state(fields, X, device="cuda", dtype: torch.dtype = torch.float64) -> MMCTM:
    """An `MMCTM` wrapper over the documents X (X[doc][modality] (n, 2)
    1-based (vocab_index, count) matrices) holding a trained state given as
    `state_from_numpy` takes it (one lane). K, V and α come from the state's
    γ and α. On the CUDA card unless the caller asks for the CPU."""
    state = _one_lane(state_from_numpy(fields, device, dtype))
    K = [g.shape[-2] for g in state.gamma]
    V = [g.shape[-1] for g in state.gamma]
    model = MMCTM(K, state.alpha[0].tolist(), V, X, dtype=dtype, device=device)
    model.state = state
    return model


def immctm_from_state(fields, features, X, device="cuda",
                      dtype: torch.dtype = torch.float64) -> IMMCTM:
    """An `IMMCTM` wrapper over the documents X with the (V_m, I_m) 1-based
    feature tables `features`, holding a trained state given as
    `immctm_state_from_numpy` takes it (one lane); K and α come from the
    state. On the CUDA card unless the caller asks for the CPU."""
    state = _one_lane(immctm_state_from_numpy(fields, device, dtype))
    K = [gm[0].shape[-2] for gm in state.gamma]
    model = IMMCTM(K, [a[0].tolist() for a in state.alpha], features, X, dtype=dtype,
                   device=device)
    model.state = state
    return model


def lda_from_state(fields, alpha, eta, X, device="cuda",
                   dtype: torch.dtype = torch.float64) -> LDA:
    """An `LDA` wrapper over the documents X ((n, 2) 1-based (vocab_index,
    count) matrices) with the hyperparameters α and η, holding a trained
    state given as `lda_state_from_numpy` takes it (one lane); K and V come
    from the state's λ. On the CUDA card unless the caller asks for the
    CPU."""
    state = _one_lane(lda_state_from_numpy(fields, device, dtype))
    V, K = state.lam.shape[-2:]
    model = LDA(K, alpha, eta, V, X, dtype=dtype, device=device)
    model.state = state
    return model


def ilda_from_state(fields, alpha, eta, features, X, device="cuda",
                    dtype: torch.dtype = torch.float64) -> ILDA:
    """An `ILDA` wrapper over the documents X with the (V, I) 1-based
    feature table `features` and the hyperparameters α and η (a scalar or
    one per feature), holding a trained state given as
    `ilda_state_from_numpy` takes it (one lane); K comes from the state. On
    the CUDA card unless the caller asks for the CPU."""
    state = _one_lane(ilda_state_from_numpy(fields, device, dtype))
    model = ILDA(state.gamma.shape[-1], alpha, eta, features, X, dtype=dtype, device=device)
    model.state = state
    return model
