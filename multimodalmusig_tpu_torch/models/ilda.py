"""Feature one-hots for the feature-factorized models, in PyTorch.

Counterpart of the one piece of multimodalmusig_tpu/models/ilda.py that
IMMCTM needs: `feature_onehots`, which turns a modality's (V, I) table of
1-based feature values into one-hot matrices, so that the reference's
nested feature loops become matrix products. ILDA itself (the model, its
fit and `fit_ilda_restarts`) is not ported yet (ROADMAP A5).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["feature_onehots"]


def feature_onehots(features, J: Sequence[int], dtype: torch.dtype = torch.float64,
                    device="cpu") -> Tuple[torch.Tensor, ...]:
    """features (V, I) with 1-based values -> per-feature one-hot (V, J_i)
    tensors of `dtype` on `device`."""
    features = np.asarray(features)
    out = []
    for i, Ji in enumerate(J):
        F = np.zeros((features.shape[0], Ji), dtype=np.float64)
        F[np.arange(features.shape[0]), features[:, i] - 1] = 1.0
        out.append(torch.as_tensor(F).to(device=device, dtype=dtype))
    return tuple(out)
