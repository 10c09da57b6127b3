"""PyTorch port, the mistral family (a uniform sliding window) on the CPU,
against the JAX package.

A tiny mistral (ModelConfig.tiny with model_type "mistral", head_dim 32, GQA
4/2, window 4), W8A8 with planted outliers, quantized by the JAX package
and carried over bit for bit (tests/test_torch_models.py).

- Teacher-forced logits against JAX's eager `forward` on a batch-major ring
  cache of 8 slots (as tests/test_kv_cache.py:120-144): a prefill in two
  chunks of 4 (the second over the populated cache), then 12 decode steps,
  so the ring wraps twice, with left-padding starts; bf16 and int8 KV.
  Decode runs kernel 8's plain version in ring mode from the window start
  max(kv_start, kv_len - 4). Logits within 5e-3 * max|logits|, the limit of
  tests/test_torch_decoder.py.
- The same model under attn_impl="flash" on a head-major cache: kernel 3's
  plain version from the same window start, against JAX's head-major
  forward (the Pallas flash kernel in interpret mode with its start
  offset), decoding past the window; the same limit.
- Greedy tokens of `generate` equal the JAX InferenceEngine's under the
  default attn_impl="auto" (both on a batch-major ring cache), at a seed
  whose top-2 margins the test asserts.
- The policy in the engine (auto: batch-major ring; flash: head-major), JAX's
  refusals of attn_impl "pallas" (its message) and "xla_int8" (not ported),
  and the ring guard: a prefill chunk that reaches the wrap of a cache
  shorter than window + chunk raises as in JAX; one that does not reach it
  is served (JAX refuses it statically), with the logits of a cache that
  never wraps.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import ModelConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

W = 4
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
GREEDY_SEED = 1


def mistral_cfg(window=W):
    return ModelConfig.tiny(model_type="mistral", sliding_window=window,
                            hidden_size=128, intermediate_size=256,
                            num_attention_heads=4, num_key_value_heads=2)


def build(seed, attn_impl="auto"):
    cfg, jp, jspecs, tp, tspecs = models.build(seed, cfg=mistral_cfg())
    return (cfg, jp, dataclasses.replace(jspecs, attn_impl=attn_impl), tp,
            dataclasses.replace(tspecs, attn_impl=attn_impl))


def _run_both(cfg, jp, jspecs, tp, tspecs, chunks, kv_dtype, S, kv_start,
              head_major):
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    jc = JKVCache.create(L, chunks[0].shape[0], S, nkv, hd,
                         jnp.dtype(kv_dtype), head_major=head_major,
                         **({"tail_r": 0} if head_major else {}))
    tc = KVCache.create(L, chunks[0].shape[0], S, nkv, hd,
                        getattr(torch, kv_dtype), head_major=head_major,
                        device="cpu")
    head = lm_head_f32(tp, tspecs)
    for chunk in chunks:
        jl, jc = j_forward(jp, jnp.asarray(chunk), jc, jspecs, cfg,
                           jnp.asarray(kv_start))
        tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, cfg,
                         torch.from_numpy(kv_start), head_f32=head)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())
    assert tc.length == int(jc.length) == sum(c.shape[1] for c in chunks)
    return tc


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_ring_cache_logits_across_the_wrap(kv_dtype):
    cfg, jp, jspecs, tp, tspecs = build(1)
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 20)).astype(np.int32)
    chunks = ([toks[:, :4], toks[:, 4:8]]
              + [toks[:, i:i + 1] for i in range(8, 20)])
    tc = _run_both(cfg, jp, jspecs, tp, tspecs, chunks, kv_dtype, 8,
                   np.array([0, 1, 3], np.int32), head_major=False)
    assert not tc.head_major and tc.max_seq == 8


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_head_major_window_start_vs_jax(kv_dtype):
    """attn_impl="flash": kernel 3 from max(kv_start, kv_len - W), JAX's
    flash start (decoder.py:549-556), decoding from 9 to 16 positions."""
    cfg, jp, jspecs, tp, tspecs = build(3, attn_impl="flash")
    toks = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (3, 16)).astype(np.int32)
    chunks = [toks[:, :8]] + [toks[:, i:i + 1] for i in range(8, 16)]
    _run_both(cfg, jp, jspecs, tp, tspecs, chunks, kv_dtype, 32,
              np.array([0, 2, 5], np.int32), head_major=True)


def test_greedy_tokens_match_jax():
    cfg, jp, jspecs, tp, tspecs = build(GREEDY_SEED)
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype="int8")
    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(device_decode_loop=False,
                                                  **ecfg))
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    got = eng.generate(PROMPTS, NEW)
    assert got == jeng.generate(PROMPTS, NEW)
    # no near-ties: replay the port's greedy run and check the margins
    toks = np.asarray(got)
    Tp = 16
    padded = np.zeros((len(PROMPTS), Tp), np.int32)
    kv_start = np.array([Tp - len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        padded[i, Tp - len(p):] = p
    cache = eng.new_cache(len(PROMPTS), 128)
    assert not cache.head_major and not jeng.new_cache(1, 128).head_major
    logits, cache = eng.prefill(padded, cache, kv_start)
    for step in range(NEW):
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 5e-3 * logits.abs().max().item(), (step, margin)
        if step + 1 < NEW:
            logits, cache = eng.decode_step(toks[:, step:step + 1], cache,
                                            kv_start)


def test_policy_and_refusals():
    cfg, jp, jspecs, tp, tspecs = build(2)
    ecfg = EngineConfig(max_seq_len=64, prefill_chunk=8, kv_dtype="int8")
    assert not InferenceEngine(tp, cfg, tspecs, ecfg,
                               device="cpu").new_cache(2).head_major
    flash = InferenceEngine(tp, cfg, dataclasses.replace(
        tspecs, attn_impl="flash"), ecfg, device="cpu")
    assert flash.new_cache(2).head_major
    out = flash.generate([[1, 5, 9, 4], [2, 2, 7]], 10)
    assert [len(r) for r in out] == [10, 10]
    toks = np.ones((2, 3), np.int32)
    cache = lambda: KVCache.create(cfg.num_hidden_layers, 2, 16,
                                   cfg.num_key_value_heads, cfg.head_dim_,
                                   device="cpu")
    head = lm_head_f32(tp, tspecs)
    with pytest.raises(ValueError) as jerr:
        j_forward(jp, jnp.asarray(toks), JKVCache.create(
            cfg.num_hidden_layers, 2, 16, cfg.num_key_value_heads,
            cfg.head_dim_), dataclasses.replace(jspecs, attn_impl="pallas"),
            cfg)
    with pytest.raises(ValueError) as terr:
        forward(tp, torch.from_numpy(toks), cache(),
                dataclasses.replace(tspecs, attn_impl="pallas"), cfg,
                head_f32=head)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError):
        forward(tp, torch.from_numpy(toks), cache(),
                dataclasses.replace(tspecs, attn_impl="xla_int8"), cfg,
                head_f32=head)


def test_ring_guard():
    cfg, jp, jspecs, tp, tspecs = build(2)
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    head = lm_head_f32(tp, tspecs)
    toks = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (2, 10)).astype(np.int32)
    # a 6-token chunk at position 4 of an 8-slot ring reaches the wrap, and
    # 8 < W + 6: both packages raise
    jc = JKVCache.create(L, 2, 8, nkv, hd)
    _, jc = j_forward(jp, jnp.asarray(toks[:, :4]), jc, jspecs, cfg)
    with pytest.raises(ValueError, match="ring KV cache"):
        j_forward(jp, jnp.asarray(toks[:, 4:]), jc, jspecs, cfg)
    tc = KVCache.create(L, 2, 8, nkv, hd, device="cpu")
    forward(tp, torch.from_numpy(toks[:, :4]), tc, tspecs, cfg,
            head_f32=head)
    with pytest.raises(ValueError, match="ring KV cache"):
        forward(tp, torch.from_numpy(toks[:, 4:]), tc, tspecs, cfg,
                head_f32=head)
    # a fresh 8-token prefill does not reach the wrap: JAX refuses it
    # statically, the port serves it with the logits of a 64-slot cache
    with pytest.raises(ValueError, match="ring KV cache"):
        j_forward(jp, jnp.asarray(toks[:, :8]), JKVCache.create(
            L, 2, 8, nkv, hd), jspecs, cfg)
    small, _ = forward(tp, torch.from_numpy(toks[:, :8]),
                       KVCache.create(L, 2, 8, nkv, hd, device="cpu"),
                       tspecs, cfg, head_f32=head)
    big, _ = forward(tp, torch.from_numpy(toks[:, :8]),
                     KVCache.create(L, 2, 64, nkv, hd, device="cpu"),
                     tspecs, cfg, head_f32=head)
    assert torch.equal(small, big)
