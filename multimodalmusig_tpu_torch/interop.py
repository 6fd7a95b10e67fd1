"""Moving MMCTM and IMMCTM states from the JAX package into this one.

`jax.random` and torch generators never draw the same numbers, so the
parity tests hand the JAX package's initial state to this package through
`state_from_numpy` / `immctm_state_from_numpy` instead of re-seeding, and a
trained state into the wrappers through `mmctm_from_state` /
`immctm_from_state`, so both packages run inference on one trained model.
The functions take plain arrays (they import neither JAX nor the JAX
package).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ctm_base import check_device
from .models.immctm import IMMCTM, IMMCTMState
from .models.mmctm import MMCTM, MMCTMState

__all__ = ["state_from_numpy", "immctm_state_from_numpy", "mmctm_from_state",
           "immctm_from_state"]

# Tuple depth of each nested field (absent: a plain array).
_MMCTM_DEPTHS = {"gamma": 1, "Elnphi": 1, "logw_pre": 1}
_IMMCTM_DEPTHS = {"alpha": 1, "gamma": 2, "Elnphi": 2, "logw_pre": 1}


def _from_numpy(cls, depths, fields, device, dtype):
    device = check_device(device)
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    batched = np.asarray(fields["mu"]).ndim == 2

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


def _one_lane(state):
    if state.lam.shape[0] != 1:
        raise ValueError(f"a wrapper holds one lane, the state has {state.lam.shape[0]}")
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
