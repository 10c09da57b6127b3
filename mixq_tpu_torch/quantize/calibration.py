"""Calibration: per-linear input-channel activation statistics (mirrors
mixq_tpu/quantize/calibration.py).

The decoder forward emits the statistics itself (collect_stats=True), so
nothing is hooked: `collect_act_scales` runs it over token batches, each on
a fresh batch-major bf16 cache of the batch's own length, and keeps the
running per-channel max on the parameters' device (JAX jit-compiles the
same forward; the port runs it eagerly). The outlier sets are the top
channels by that max, ties by the lower index (`ops/quant.py::
top_indices`).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from mixq_tpu_torch.config import ModelConfig, QuantConfig
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.ops import quant as Q


def stats_forward(params: DecoderParams, cfg: ModelConfig,
                  specs: DecoderSpecs, batch,
                  head_f32: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """One forward of a [B, T] token batch on a fresh batch-major bf16
    cache of length T, returning its per-linear-group channel absmax
    {"{layer}.{wqkv|wo|up|down}": [K] f32} on the parameters' device."""
    dev = params.embed.device
    tokens = torch.as_tensor(np.asarray(batch, np.int32), device=dev)
    B, T = tokens.shape
    cache = KVCache.create(cfg.num_hidden_layers, B, T,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           torch.bfloat16, head_major=False, device=dev)
    if head_f32 is None:
        head_f32 = lm_head_f32(params, specs)
    with torch.inference_mode():
        return forward(params, tokens, cache, specs, cfg,
                       head_f32=head_f32, collect_stats=True)[2]


def collect_act_scales(
    params: DecoderParams,
    cfg: ModelConfig,
    batches: Iterable,                  # each [B, T] int token batch
    specs: Optional[DecoderSpecs] = None,
) -> Dict[str, torch.Tensor]:
    """Run fp forwards over calibration batches and return the running
    max of each linear group's channel absmax, {"{layer}.{wqkv|wo|up|down}":
    [K] f32 tensor} on the parameters' device (JAX returns numpy)."""
    specs = specs or DecoderSpecs.fp16()
    head_f32 = lm_head_f32(params, specs)
    acc: Dict[str, torch.Tensor] = {}
    for batch in batches:
        for k, v in stats_forward(params, cfg, specs, batch,
                                  head_f32).items():
            acc[k] = torch.maximum(acc[k], v) if k in acc else v
    return acc


def save_act_scales(scales: Dict, path: str) -> None:
    """An .npz of the scales (numpy only; tensors are copied to the
    host)."""
    np.savez(path, **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v)) for k, v in scales.items()})


def load_act_scales(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _scale_tensor(s, device) -> torch.Tensor:
    s = s if isinstance(s, torch.Tensor) else torch.from_numpy(
        np.asarray(s, np.float32))
    return s.to(device=device, dtype=torch.float32)


def outlier_sets_from_scales(
    scales: Dict,
    qcfg: QuantConfig,
    n_outliers: Optional[int] = None,
    device="cuda",
) -> Dict[str, Q.OutlierSet]:
    """The top-N channels of each linear group as static fp outliers (the
    reference's top fp_features channels by calibration scale), made on
    `device` whatever the scales' type or device."""
    n = n_outliers if n_outliers is not None else qcfg.outlier_budget
    out = {}
    for key, s in scales.items():
        s = _scale_tensor(s, device)
        k = s.shape[0]
        out[key] = Q.top_k_outliers_from_scales(
            s, n=min(n, k, qcfg.outlier_budget), k=k,
            budget=qcfg.outlier_budget)
    return out


def sigma_outlier_sets_from_scales(
    scales: Dict,
    qcfg: QuantConfig,
    device="cuda",
) -> Dict[str, Q.OutlierSet]:
    """Alternative policy: the channels whose calibration absmax exceeds
    sigma (the online predictor's threshold, applied offline), the largest
    first, capped at the budget; made on `device`."""
    out = {}
    for key, s in scales.items():
        s = _scale_tensor(s, device)
        k = s.shape[0]
        n = int(min(int((s > qcfg.outlier_sigma).sum()),
                    qcfg.outlier_budget))
        if n == 0:
            out[key] = Q.empty_outlier_set(k, qcfg.outlier_budget,
                                           device=s.device)
        else:
            out[key] = Q.top_k_outliers_from_scales(
                s, n=n, k=k, budget=qcfg.outlier_budget)
    return out
