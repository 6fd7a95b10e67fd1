"""Moving MMCTM states from the JAX package into this one.

`jax.random` and torch generators never draw the same numbers, so the
parity tests hand the JAX package's initial state to this package through
`state_from_numpy` instead of re-seeding. The function takes plain arrays
(it imports neither JAX nor the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.mmctm import MMCTMState

__all__ = ["state_from_numpy"]

_TUPLE_FIELDS = ("gamma", "Elnphi", "logw_pre")


def state_from_numpy(fields, device="cpu", dtype: torch.dtype = torch.float64) -> MMCTMState:
    """An MMCTMState of this package from arrays under the JAX package's
    field names (mu, Sigma, invSigma, alpha, gamma, Elnphi, lam, nu, zeta,
    lam_pre, logw_pre) — a mapping, or any NamedTuple such as the JAX
    MMCTMState itself — unbatched (μ is (MK,)) or with a leading restart
    dimension R (μ is (R, MK)). An unbatched state becomes one lane."""
    if hasattr(fields, "_asdict"):
        fields = fields._asdict()
    batched = np.asarray(fields["mu"]).ndim == 2

    def convert(a):
        t = torch.as_tensor(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)
        return t if batched else t.unsqueeze(0)

    return MMCTMState(**{
        name: tuple(convert(a) for a in fields[name]) if name in _TUPLE_FIELDS
        else convert(fields[name])
        for name in MMCTMState._fields
    })
