"""Metrics (the reference's mse and mbs_mse, solvers.cpp:167-175;
code/solvers.py:85-89).

Counterpart of ``multivartv_tpu/utils/metrics.py``.
"""

from __future__ import annotations

import torch


def mse(fits, y) -> torch.Tensor:
    """Mean squared difference of two arrays of equal size, flattened, in
    fits' type and on its device (numpy inputs stay on the CPU)."""
    fits = torch.as_tensor(fits).reshape(-1)
    y = torch.as_tensor(y, dtype=fits.dtype, device=fits.device).reshape(-1)
    return torch.mean(torch.square(fits - y))
