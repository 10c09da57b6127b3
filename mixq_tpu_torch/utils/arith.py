"""Arithmetic that rounds the same way on every device."""
from __future__ import annotations

import torch


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division on every device.

    On CUDA, PyTorch divides by a Python number (or by a 0-dim tensor on
    the CPU, which it takes as one) as a multiply by the number's
    reciprocal, which is an ulp off now and then; the CUDA kernels, the
    Pallas kernels and PyTorch's CPU run divide. So the divisor goes in as
    a 0-dim tensor on x's own device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
