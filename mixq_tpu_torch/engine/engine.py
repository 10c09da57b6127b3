"""Inference engine over a static KV cache (mirrors
mixq_tpu/engine/engine.py).

    prefill(tokens [B, Tp], cache, kv_start) -> (last logits, cache)
    decode_step(tokens [B, 1], cache, kv_start) -> (logits, cache)
    generate(prompts, ...) -> token lists

Eager PyTorch: the cache is written in place, and `generate` is a stepwise
host loop (sample, then the next decode step). The head is widened to f32
once, when the engine is built (`lm_head_f32`), not on every step. The
cache layout comes from JAX's policy (`use_head_major_cache` on
`specs.attn_impl`, the KV type and the cache length): head-major for
kernel 3, batch-major (a ring for a uniform sliding window) for kernel 8.
JAX's one-program device decode loop and its tail-window staging and
flushes are not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.engine.sampling import (SamplingParams, chosen_logprob,
                                            sample)
from mixq_tpu_torch.kernels.flash_decode import use_head_major_cache
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.utils.shapes import round_up

_KV_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


class InferenceEngine:
    """Single-device inference engine. `params` must already live on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        params: DecoderParams,
        model_cfg: ModelConfig,
        specs: DecoderSpecs,
        engine_cfg: Optional[EngineConfig] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.model_cfg = model_cfg
        self.specs = specs
        self.engine_cfg = engine_cfg or EngineConfig()
        if self.engine_cfg.kv_dtype not in _KV_DTYPES:
            raise NotImplementedError(
                f"kv_dtype {self.engine_cfg.kv_dtype!r}: bfloat16 or int8")
        # the f32 head [H, V] that every forward's logits product reads
        # (4 bytes per element, held for the engine's life)
        self.head_f32 = lm_head_f32(params, specs)

    def new_cache(self, batch: int, max_seq: Optional[int] = None) -> KVCache:
        """A fresh cache in the layout the policy gives (JAX's new_cache
        without the tail staging)."""
        mc = self.model_cfg
        S = max_seq or self.engine_cfg.max_seq_len
        dtype = _KV_DTYPES[self.engine_cfg.kv_dtype]
        return KVCache.create(
            mc.num_hidden_layers, batch, S, mc.num_key_value_heads,
            mc.head_dim_, dtype=dtype,
            head_major=use_head_major_cache(self.specs.attn_impl, mc, S,
                                            dtype.itemsize),
            device=self.device)

    def _rows(self, x, B: int) -> torch.Tensor:
        if x is None:
            return torch.zeros((B,), dtype=torch.int32, device=self.device)
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    @torch.inference_mode()
    def prefill(self, tokens, cache: KVCache, kv_start=None):
        """Prefill a [B, Tp] token chunk (on a head-major cache, a fresh
        one); returns the last position's logits [B, V] and the cache."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, cache = forward(self.params, tokens, cache, self.specs,
                                self.model_cfg,
                                self._rows(kv_start, tokens.shape[0]),
                                head_f32=self.head_f32)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def decode_step(self, tokens, cache: KVCache, kv_start=None):
        """One decode step on [B, 1] tokens; returns logits [B, V]."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, cache = forward(self.params, tokens, cache, self.specs,
                                self.model_cfg,
                                self._rows(kv_start, tokens.shape[0]),
                                head_f32=self.head_f32)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 128,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        return_logprobs: bool = False,
    ):
        """Batched generation from token-id prompts, left-padded to a common
        length rounded up to `prefill_chunk`; per-row `kv_start` masks the
        padding. Rows stop at their first eos (and emit eos after it)."""
        B = len(prompts)
        if B == 0:
            raise ValueError("empty prompt batch")
        lens = [len(p) for p in prompts]
        if min(lens) == 0:
            raise ValueError("prompts must contain at least one token")
        Tp = min(round_up(max(lens), self.engine_cfg.prefill_chunk),
                 self.engine_cfg.max_seq_len)
        if max(lens) > Tp:
            raise ValueError("prompt longer than max_seq_len")
        tokens = np.full((B, Tp), pad_token_id, np.int32)
        kv_start = np.zeros((B,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, Tp - len(p):] = p
            kv_start[i] = Tp - len(p)
        kv_start_t = self._rows(kv_start, B)

        cache = self.new_cache(B, round_up(Tp + max_new_tokens, 128))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.prefill(torch.from_numpy(tokens), cache,
                                     kv_start_t)
        tok = sample(logits, gen, sampling)
        out_tokens, out_lps = [tok], []
        if return_logprobs:
            out_lps.append(chosen_logprob(logits, tok))
        done = (tok == eos_token_id if eos_token_id is not None else None)
        for _ in range(1, max_new_tokens):
            if done is not None and bool(done.all()):
                break
            logits, cache = self.decode_step(tok[:, None], cache, kv_start_t)
            tok = sample(logits, gen, sampling)
            if done is not None:
                tok = torch.where(done, eos_token_id, tok)
                done = done | (tok == eos_token_id)
            out_tokens.append(tok)
            if return_logprobs:
                out_lps.append(chosen_logprob(logits, tok))
        gen_toks = torch.stack(out_tokens, dim=1).cpu().numpy()
        gen_lps = (torch.stack(out_lps, dim=1).cpu().numpy()
                   if return_logprobs else None)
        results: List[List[int]] = []
        lp_results: List[List[float]] = []
        for i in range(B):
            row = gen_toks[i].tolist()
            if eos_token_id is not None and eos_token_id in row:
                row = row[: row.index(eos_token_id) + 1]
            results.append(row)
            if return_logprobs:
                lp_results.append(gen_lps[i, :len(row)].tolist())
        if return_logprobs:
            return results, lp_results
        return results
