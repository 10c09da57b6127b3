"""Arithmetic that rounds the same way on every device."""
from __future__ import annotations

import functools

import torch


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division on every device.

    On CUDA, PyTorch divides by a Python number (or by a 0-dim tensor on
    the CPU, which it takes as one) as a multiply by the number's
    reciprocal, which is an ulp off now and then; the CUDA kernels, the
    Pallas kernels and PyTorch's CPU run divide. So the divisor goes in as
    a 0-dim tensor on x's own device."""
    return x / _divisor(float(d), x.dtype, x.device)


@functools.lru_cache(maxsize=64)
def _divisor(d: float, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """The 0-dim tensor d on `device`, made once: a fresh one would cost a
    fill kernel on the card at every call (the quantizers call true_div in
    every layer of every step). Only read, never written."""
    return torch.full((), d, dtype=dtype, device=device)
