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
    return x / constant(float(d), x.dtype, x.device)


@functools.lru_cache(maxsize=64)
def constant(d: float, dtype: torch.dtype, device: torch.device
             ) -> torch.Tensor:
    """The 0-dim tensor d (rounded to `dtype`) on `device`, made once: a
    fresh one would cost a fill kernel on the card at every call (the
    quantizers divide in every layer of every step), and a CUDA graph of
    the decode step cannot hold its making (the first, eager step makes
    every constant the step needs). Only read, never written. Made outside
    inference mode whatever the caller's mode, so that a forward under
    autograd (training) may save it for backward after an inference-mode
    forward made it."""
    with torch.inference_mode(False):
        return torch.full((), d, dtype=dtype, device=device)
