"""Source statistics of the rate-distortion analysis (paper §IV;
``repro/core/rate_distortion.py``).

Only what serving needs so far: the exponential-rate estimator behind the
KV-cache statistic λ_kv (``runtime.decode_engine.fit_kv_lambda``).  The
bounds and the Blahut-Arimoto estimate wait for their slice.
"""

from __future__ import annotations

import torch


def exponential_mle(magnitudes: torch.Tensor) -> torch.Tensor:
    """MLE of the Exponential rate, ``1 / mean(|theta|)`` over every
    element, guarded to stay finite for an all-zero input."""
    m = torch.mean(torch.abs(magnitudes.to(torch.float32)))
    return 1.0 / torch.clamp(m, min=torch.finfo(torch.float32).tiny)
