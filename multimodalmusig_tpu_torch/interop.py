"""Moving MMCTM and IMMCTM states from the JAX package into this one.

`jax.random` and torch generators never draw the same numbers, so the
parity tests hand the JAX package's initial state to this package through
`state_from_numpy` / `immctm_state_from_numpy` instead of re-seeding. The
functions take plain arrays (they import neither JAX nor the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.ctm_base import check_device
from .models.immctm import IMMCTMState
from .models.mmctm import MMCTMState

__all__ = ["state_from_numpy", "immctm_state_from_numpy"]

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
