"""Sliding-window perplexity (mirrors mixq_tpu/eval/perplexity.py).

The reference's llama.cpp-style perplexity:
  - the token stream is cut into n_ctx windows;
  - the first token of each window is replaced by BOS;
  - NLL is summed over the second half of each window only (targets t + 1
    in [n_ctx / 2, n_ctx));
  - ppl = exp(total_nll / count).
Windows go through the decoder in batches of `batch_size`, each batch on a
fresh batch-major cache of `kv_dtype` (JAX's default layout), on the
params' device. A short last batch runs at its own size (JAX pads it and
drops the pad rows). This is the evaluation behind the PPL gate:
BASELINE.md asks for W8A8O16 within 0.1 of FP16.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.engine.engine import _KV_DTYPES
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache


def kv_torch_dtype(kv_dtype) -> torch.dtype:
    """A KV type given as torch.bfloat16 / torch.int8 or by the engine's
    name for it."""
    if isinstance(kv_dtype, torch.dtype):
        return kv_dtype
    return _KV_DTYPES[str(kv_dtype)]


@dataclasses.dataclass
class PerplexityResult:
    ppl: float
    nll: float
    n_tokens: int
    n_windows: int

    def __repr__(self):
        return (f"PerplexityResult(ppl={self.ppl:.4f}, "
                f"tokens={self.n_tokens}, windows={self.n_windows})")


def window_nll(params: DecoderParams, tokens: torch.Tensor,
               specs: DecoderSpecs, cfg: ModelConfig, kv_dtype,
               head_f32: torch.Tensor) -> torch.Tensor:
    """Per-window NLL over the second half: tokens [B, n_ctx] -> [B] f32."""
    B, n_ctx = tokens.shape
    cache = KVCache.create(cfg.num_hidden_layers, B, n_ctx,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           kv_torch_dtype(kv_dtype), device=tokens.device)
    logits, _ = forward(params, tokens, cache, specs, cfg,
                        head_f32=head_f32)
    logp = torch.log_softmax(logits.float(), dim=-1)
    # logits[:, t] predicts tokens[:, t + 1]; count t + 1 in [n_ctx/2, n_ctx)
    targets = tokens[:, 1:].long()
    pred_lp = torch.gather(logp[:, :-1], -1, targets[..., None])[..., 0]
    mask = (torch.arange(1, n_ctx, device=tokens.device)
            >= n_ctx // 2).float()
    return -torch.sum(pred_lp * mask[None, :], dim=-1)


@torch.inference_mode()
def compute_perplexity(
    params: DecoderParams,
    cfg: ModelConfig,
    token_ids: np.ndarray,          # [N] the dataset's token stream
    specs: Optional[DecoderSpecs] = None,
    n_ctx: int = 512,
    batch_size: int = 8,
    bos_token_id: int = 1,
    kv_dtype=torch.bfloat16,
    max_windows: Optional[int] = None,
) -> PerplexityResult:
    """PPL of the stream on the params' device; the head is widened once
    per call (lm_head_f32)."""
    specs = specs or DecoderSpecs.fp16()
    token_ids = np.asarray(token_ids, np.int32).reshape(-1)
    n_windows = len(token_ids) // n_ctx
    if max_windows is not None:
        n_windows = min(n_windows, max_windows)
    if n_windows == 0:
        raise ValueError(f"need at least {n_ctx} tokens, got {len(token_ids)}")

    windows = token_ids[: n_windows * n_ctx].reshape(n_windows, n_ctx).copy()
    windows[:, 0] = bos_token_id          # BOS substitution
    device = params.embed.device
    head = lm_head_f32(params, specs)

    total_nll, total_count = 0.0, 0
    for i in range(0, n_windows, batch_size):
        batch = torch.from_numpy(windows[i: i + batch_size]).to(device)
        per_window = window_nll(params, batch, specs, cfg, kv_dtype, head)
        total_nll += float(per_window.cpu().numpy().sum())
        total_count += batch.shape[0] * (n_ctx - n_ctx // 2)

    ppl = math.exp(total_nll / total_count)
    return PerplexityResult(ppl=ppl, nll=total_nll, n_tokens=total_count,
                            n_windows=n_windows)
