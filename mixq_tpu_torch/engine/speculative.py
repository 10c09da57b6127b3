"""Prompt-lookup speculative decoding: n-gram drafting, no draft model
(mirrors mixq_tpu/engine/speculative.py).

Greedy decode emits one token per forward. When the continuation repeats a
span already seen, the next tokens can be guessed from the history and
verified in one T=k forward: the model's own argmax decides how much of
the draft survives, so the output is greedy decode's, in fewer sequential
forwards.

`propose_ngram` drafts on the host from one history. `propose_ngram_device`
drafts for a whole slot batch on the device, row for row the same, with
fixed shapes and no host read, so a CUDA graph holds it (the continuous-
batching engine's spec window, engine/batching.py). `accept_greedy` is the
accepted-prefix length per row. `generate_speculative` is greedy generation
of one prompt through `InferenceEngine`'s params on a batch-major cache of
its own, as JAX's: a rejected suffix rewinds the cache's length in place
(`KVCache.set_length`); the stale positions past it are masked and
overwritten by the next verify.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mixq_tpu_torch.models.decoder import forward
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.utils.shapes import round_up


def propose_ngram(history: Sequence[int], n: int, k: int) -> List[int]:
    """Up to k tokens that followed the most recent earlier occurrence of
    the trailing n-gram; [] when it never occurred before."""
    h = list(history)
    if len(h) <= n:
        return []
    tail = h[-n:]
    for start in range(len(h) - n - 1, -1, -1):
        if h[start:start + n] == tail:
            return h[start + n:start + n + k]
    return []


def propose_ngram_device(hist: torch.Tensor, hlen: torch.Tensor, n: int,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`propose_ngram` for every row of a slot batch on the device.

    hist: [B, H] int32 histories (left-aligned), hlen: [B] valid lengths.
    Returns (draft [B, k] int32, draft_len [B] int32): per row, up to k
    followers of the most recent earlier occurrence of the trailing n-gram
    (draft_len 0 when there is none). Fixed shapes, no host read."""
    B, H = hist.shape
    dev = hist.device
    P = H - n + 1                       # candidate n-gram starts
    hl = hlen.long()[:, None]
    tail_idx = (hl - n + torch.arange(n, device=dev)[None]).clamp(0, H - 1)
    tail = torch.gather(hist, 1, tail_idx)
    m = torch.ones((B, P), dtype=torch.bool, device=dev)
    for j in range(n):
        m &= hist[:, j:P + j] == tail[:, j:j + 1]
    p = torch.arange(P, device=dev)[None]
    # an earlier occurrence with at least one follower in the history
    m &= (p <= hl - n - 1) & (hl > n)
    p_star = torch.where(m, p, -1).amax(dim=1)                  # [B]
    fol = (p_star[:, None] + n
           + torch.arange(k, device=dev)[None]).clamp(0, H - 1)
    draft = torch.gather(hist, 1, fol).to(torch.int32)
    draft_len = torch.where(p_star >= 0,
                            torch.clamp_max(hlen.long() - (p_star + n), k),
                            0).to(torch.int32)
    return draft, draft_len


def accept_greedy(preds: torch.Tensor, draft: torch.Tensor,
                  draft_len: torch.Tensor) -> torch.Tensor:
    """Per-row count of leading draft tokens that the model's argmax agrees
    with (preds[j] consumed feed[:j + 1]). preds, draft [B, k]; draft_len
    [B]. Returns [B] int32 in [0, draft_len]."""
    j = torch.arange(draft.shape[1], device=draft.device)[None]
    match = (preds == draft) & (j < draft_len[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


@torch.inference_mode()
def generate_speculative(
    engine,
    prompt: Sequence[int],
    max_new_tokens: int = 128,
    ngram: int = 3,
    k: int = 8,
    eos_token_id: Optional[int] = None,
) -> Tuple[List[int], Dict[str, int]]:
    """Greedy generation of one prompt with prompt-lookup speculation
    through `engine` (an InferenceEngine). Returns (tokens, stats): the
    tokens greedy decode gives, and the forwards, drafted and accepted
    tokens it took."""
    cfg, specs, ecfg = engine.model_cfg, engine.specs, engine.engine_cfg
    n = len(prompt)
    if n > ecfg.max_seq_len:
        raise ValueError(f"prompt ({n} tokens) longer than max_seq_len "
                         f"({ecfg.max_seq_len})")
    if n == 0:
        raise ValueError("empty prompt")
    from mixq_tpu_torch.engine.engine import _KV_DTYPES

    Tp = min(round_up(n, ecfg.prefill_chunk), ecfg.max_seq_len)
    # batch-major: the verify is a T=k forward over a populated cache
    cache = KVCache.create(
        cfg.num_hidden_layers, 1, round_up(Tp + max_new_tokens + k, 128),
        cfg.num_key_value_heads, cfg.head_dim_,
        dtype=_KV_DTYPES[ecfg.kv_dtype], device=engine.device)
    toks = np.zeros((1, Tp), np.int32)
    toks[0, Tp - n:] = prompt
    kv_start = torch.tensor([Tp - n], dtype=torch.int32,
                            device=engine.device)
    logits, cache = engine.prefill(torch.from_numpy(toks), cache, kv_start)
    history = list(prompt)
    out: List[int] = [int(torch.argmax(logits[0]))]
    history.append(out[0])
    stats = {"forwards": 1, "drafted": 0, "accepted": 0}
    feed = torch.zeros((1, k), dtype=torch.int32, device=engine.device)
    while len(out) < max_new_tokens:
        if eos_token_id is not None and out[-1] == eos_token_id:
            break
        draft = propose_ngram(history, ngram, k - 1)
        # [last token, draft...] padded to k: position j's argmax is the
        # model's token after feed[:j + 1]
        feed.copy_(torch.tensor([([out[-1]] + draft
                                  + [0] * (k - 1 - len(draft)))[:k]]))
        logits, cache = forward(engine.params, feed, cache, specs, cfg,
                                kv_start, head_f32=engine.head_f32)
        stats["forwards"] += 1
        stats["drafted"] += len(draft)
        preds = torch.argmax(logits[0], dim=-1).tolist()
        a = 0
        while a < len(draft) and preds[a] == draft[a]:
            a += 1
        new = draft[:a] + [preds[a]]
        stats["accepted"] += a
        out.extend(new)
        history.extend(new)
        # the verify wrote k positions, of which 1 + a are real
        cache.set_length(cache.host_length - (k - 1 - a))
        if eos_token_id is not None and eos_token_id in new:
            out = out[:len(out) - len(new) + new.index(eos_token_id) + 1]
            break
    return out[:max_new_tokens], stats
