"""EleutherAI lm-evaluation-harness adaptor (mirrors
mixq_tpu/eval/lm_eval_adaptor.py). The base class is lm_eval's `LM` where
lm_eval is installed and `object` elsewhere: the scoring below needs no
harness, so the adaptor is constructible and testable without it."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

try:
    from lm_eval.api.model import LM  # lm-eval >= 0.4 API
except Exception:  # pragma: no cover - environment without lm_eval
    LM = object

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache


class MixQLM(LM):
    """lm-eval LM over the port's decoder, on the params' device:
    loglikelihood through one forward per (context + continuation) batch,
    generate_until through an InferenceEngine."""

    def __init__(self, params: DecoderParams, cfg: ModelConfig,
                 specs: DecoderSpecs, tokenizer, batch_size: int = 8,
                 max_length: int = 2048):
        super().__init__()
        self.params = params
        self.cfg = cfg
        self.specs = specs
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length
        self.device = params.embed.device
        self.head_f32 = lm_head_f32(params, specs)   # widened once

    @torch.inference_mode()
    def _score(self, prompts: List[Tuple[List[int], List[int]]]):
        """[(ctx_ids, cont_ids)] -> [(logprob, is_greedy)]: the batch
        left-padded to [B, T] with per-row `kv_start`, on a bf16
        batch-major cache."""
        B = len(prompts)
        T = min(self.max_length,
                max(len(c) + len(x) for c, x in prompts))
        toks = np.zeros((B, T), np.int32)
        start = np.zeros((B,), np.int32)
        spans = []
        for i, (ctx, cont) in enumerate(prompts):
            ids = (ctx + cont)[-T:]
            toks[i, T - len(ids):] = ids
            start[i] = T - len(ids)
            # the first continuation slot, clamped to 1 so slot t's logprob
            # always comes from the prediction at t - 1 (a continuation
            # that fills the whole window loses its first token)
            spans.append((max(T - len(cont), 1), T))
        cfg = self.cfg
        cache = KVCache.create(cfg.num_hidden_layers, B, T,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               torch.bfloat16, device=self.device)
        logits, _ = forward(self.params,
                            torch.from_numpy(toks).to(self.device), cache,
                            self.specs, cfg,
                            torch.from_numpy(start).to(self.device),
                            head_f32=self.head_f32)
        logp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
        out = []
        for i, (lo, hi) in enumerate(spans):
            lp, greedy = 0.0, True
            for t in range(lo, hi):
                tok = toks[i, t]
                lp += float(logp[i, t - 1, tok])
                greedy &= int(np.argmax(logp[i, t - 1])) == int(tok)
            out.append((lp, greedy))
        return out

    # -- lm-eval API -------------------------------------------------------

    def loglikelihood(self, requests):
        results = []
        pairs = []
        for req in requests:
            ctx, cont = req.args
            ctx_ids = self.tokenizer(ctx).input_ids if ctx else [
                self.tokenizer.bos_token_id or 1]
            cont_ids = self.tokenizer(
                cont, add_special_tokens=False).input_ids
            pairs.append((ctx_ids, cont_ids))
        for i in range(0, len(pairs), self.batch_size):
            results.extend(self._score(pairs[i:i + self.batch_size]))
        return results

    def loglikelihood_rolling(self, requests):
        results = []
        for req in requests:
            (text,) = req.args
            ids = self.tokenizer(text).input_ids
            (lp, _), = self._score([([self.tokenizer.bos_token_id or 1],
                                     ids[: self.max_length - 1])])
            results.append(lp)
        return results

    def generate_until(self, requests):
        """Greedy generation, one InferenceEngine per call (as JAX builds
        one), one request at a time."""
        from mixq_tpu_torch.config import EngineConfig
        from mixq_tpu_torch.engine import InferenceEngine

        engine = InferenceEngine(self.params, self.cfg, self.specs,
                                 EngineConfig(max_seq_len=self.max_length),
                                 device=self.device)
        outs = []
        for req in requests:
            ctx, gen_kwargs = req.args
            ids = self.tokenizer(ctx).input_ids
            max_new = int(gen_kwargs.get("max_gen_toks", 128))
            toks = engine.generate([ids], max_new_tokens=max_new)[0]
            outs.append(self.tokenizer.decode(toks))
        return outs
