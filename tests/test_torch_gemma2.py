"""PyTorch port, the gemma2 family on the CPU, against the JAX package.

A tiny gemma2 (ModelConfig.tiny with gemma2's fields, as
tests/test_engine_matrix.py builds it): head_dim 32, GQA 4/2, the sqrt(H)
embedding multiplier, post-attention and post-FFW norms, the GeGLU MLP
(gelu_pytorch_tanh, the gelu_new epilogue of the gate GEMM), a
query_pre_attn_scalar of 24 so that the score scale differs from
1/sqrt(head_dim), attention and final-logit softcaps, a tied head, and
alternating windows of 256 >= every cache's max_seq. Every norm scale is
drawn from N(1, 0.1) (JAX's init makes them ones) so that the norms' weights
count. The linears are quantized by the JAX package (tests/
test_torch_models.py) and carried over bit for bit.

- Teacher-forced prefill + 4 decode steps against JAX `forward` on a
  head-major cache (attn_impl="flash", Pallas in interpret mode): W8A8,
  W4A4 (resolve_specs) and W8A16, each with bf16 and int8 KV. The caps bind
  without saturating: on this model |score| averages 0.052 (at most 0.19)
  and |logit| 0.18 (at most 0.8), so the attention cap is 0.15 and the final
  cap 0.6, about three times the typical value; the test shows that each
  cap moves the logits beyond 5x the limit (the attention cap by 7-43x,
  the final cap by ~100x). Logits within 5e-3 * max|logits|, the limit of
  tests/test_torch_decoder.py, in every configuration: the port repeats
  JAX's eager arithmetic (it reads ~2e-7 here at W4A4 too), so 4-bit
  activations need no wider limit; at W4A4 the test also measures JAX's
  own jit-vs-eager spread (0.32 of max|logits|) and finds the limit inside
  it.
- Greedy tokens of `generate` equal the JAX InferenceEngine's at the
  published caps (50, 30), seed 13. JAX's jitted engine and its eager
  forward (which the port matches to ~1e-7) differ by up to ~2e-2 *
  max|logits| on these models, so near-ties flip between the two; seed 13
  is one whose top-2 margins stay above 2e-2 * max|logits| on every step,
  which the test asserts.
- The guard: an explicit head-major cache longer than the window raises
  NotImplementedError, in JAX and in the port. Where the window binds JAX
  serves the model on the batch-major cache, and so does the port: the
  engine's policy takes it for generate's 128-slot cache (tokens equal to
  JAX's engine), and a uniform window (mistral-style) is served over a
  batch-major ring cache (logits against JAX's forward).
- convert carries the post-norm scales, and the port's own init makes them.
"""
import dataclasses

import jax
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
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.models.decoder import (forward, init_decoder_params,
                                           lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

STEPS = 4
WINDOW = 256
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
GREEDY_SEED = 13
NORMS = ("ln1_scale", "ln2_scale", "post_attn_norm_scale",
         "post_ffw_norm_scale")
# caps about three times the typical |score| and |logit| of this model
ATTN_CAP, FINAL_CAP = 0.15, 0.6


def gemma2_cfg(attn_cap=50.0, final_cap=30.0, window=WINDOW):
    return ModelConfig.tiny(
        model_type="gemma2", hidden_size=128, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh", gated_mlp=True,
        tie_word_embeddings=True, embed_multiplier=128 ** 0.5,
        post_norms=True, query_pre_attn_scalar=24.0,
        attn_logit_softcap=attn_cap, final_logit_softcap=final_cap,
        sliding_window=window, sliding_window_pattern=2)


def build(seed, config, cfg):
    """models.build on a gemma2 config, every norm scale from N(1, 0.1)."""
    cfg, jp, jspecs, _, tspecs = models.build(
        seed, qcfg=models.CONFIGS.get(config), cfg=cfg)
    rng = np.random.default_rng(seed + 100)

    def r(a):
        return jnp.asarray(1 + 0.1 * rng.standard_normal(a.shape), a.dtype)

    jp = jp._replace(
        blocks=tuple(bp._replace(**{f: r(getattr(bp, f)) for f in NORMS})
                     for bp in jp.blocks),
        lnf_scale=r(jp.lnf_scale))
    tp = decoder_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg, jp, jspecs, tp, tspecs


def _jax_logits(fwd, jp, jspecs, cfg, chunks, kv_dtype, S, kv_start):
    c = JKVCache.create(cfg.num_hidden_layers, chunks[0].shape[0], S,
                        cfg.num_key_value_heads, cfg.head_dim_,
                        jnp.dtype(kv_dtype), head_major=True, tail_r=0)
    out = []
    for chunk in chunks:
        lg, c = fwd(jp, jnp.asarray(chunk), c, jspecs, cfg,
                    jnp.asarray(kv_start))
        out.append(np.asarray(lg))
    return out


def _port_logits(tp, tspecs, cfg, chunks, kv_dtype, S, kv_start):
    tc = KVCache.create(cfg.num_hidden_layers, chunks[0].shape[0], S,
                        cfg.num_key_value_heads, cfg.head_dim_,
                        getattr(torch, kv_dtype), head_major=True,
                        device="cpu")
    head = lm_head_f32(tp, tspecs)
    out = []
    for chunk in chunks:
        tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, cfg,
                         torch.from_numpy(kv_start), head_f32=head)
        out.append(tl)
    assert tc.length == sum(c.shape[1] for c in chunks)
    return out


@pytest.mark.parametrize("config,kv_dtype", [
    (None, "bfloat16"), (None, "int8"), ("w4a4", "bfloat16"),
    ("w4a4", "int8"), ("w8a16", "bfloat16"), ("w8a16", "int8")])
def test_teacher_forced_logits(config, kv_dtype):
    cfg, jp, jspecs, tp, tspecs = build(1, config,
                                        gemma2_cfg(ATTN_CAP, FINAL_CAP))
    B, T, S = 3, 8, 32
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (B, T + STEPS)).astype(np.int32)
    kv_start = np.array([0, 3, 5], np.int32)
    chunks = [toks[:, :T]] + [toks[:, T + i:T + i + 1] for i in range(STEPS)]
    ref = _jax_logits(j_forward, jp, jspecs, cfg, chunks, kv_dtype, S,
                      kv_start)
    limit = 5e-3 * max(np.abs(r).max() for r in ref)
    if config == "w4a4":
        # JAX's own jitted forward leaves its eager one by far more at 4
        # bits (0.32 of max|logits| here): the limit is well inside it
        jit = _jax_logits(jax.jit(j_forward, static_argnums=(3, 4)), jp,
                          jspecs, cfg, chunks, kv_dtype, S, kv_start)
        assert max(np.abs(a - b).max() for a, b in zip(jit, ref)) > limit
    got = _port_logits(tp, tspecs, cfg, chunks, kv_dtype, S, kv_start)
    for tl, jl in zip(got, ref):
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=limit)
    # each cap binds: without it the logits move far beyond the limit
    for uncapped in (dataclasses.replace(cfg, attn_logit_softcap=None),
                     dataclasses.replace(cfg, final_logit_softcap=None)):
        free = _port_logits(tp, tspecs, uncapped, chunks, kv_dtype, S,
                            kv_start)
        assert max(np.abs(f.numpy() - jl).max()
                   for f, jl in zip(free, ref)) > 5 * limit
    # and the final cap does not saturate: a typical |logit| is well below
    assert np.mean([np.abs(r).mean() for r in ref]) < FINAL_CAP / 2


@pytest.mark.parametrize("kv_dtype,config", [
    ("bfloat16", None), ("int8", None), ("int8", "w8a16")])
def test_greedy_tokens_match_jax(kv_dtype, config):
    cfg, jp, jspecs, tp, tspecs = build(GREEDY_SEED, config,
                                        gemma2_cfg())
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    ref = JEngine(jp, cfg, jspecs, JEngineConfig(
        device_decode_loop=False, **ecfg)).generate(PROMPTS, NEW)
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    got = eng.generate(PROMPTS, NEW)
    assert got == ref
    # no near-ties: replay the port's greedy run and check the margins
    toks = np.asarray(got)
    Tp = 16
    padded = np.zeros((len(PROMPTS), Tp), np.int32)
    kv_start = np.array([Tp - len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        padded[i, Tp - len(p):] = p
    cache = eng.new_cache(len(PROMPTS), 128)
    logits, cache = eng.prefill(padded, cache, kv_start)
    for step in range(NEW):
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 2e-2 * logits.abs().max().item(), (step, margin)
        if step + 1 < NEW:
            logits, cache = eng.decode_step(toks[:, step:step + 1], cache,
                                            kv_start)


def test_binding_window_raises_as_in_jax():
    cfg, jp, jspecs, tp, tspecs = build(1, None, gemma2_cfg(window=16))
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    toks = np.ones((2, 4), np.int32)
    with pytest.raises(NotImplementedError):
        j_forward(jp, jnp.asarray(toks), JKVCache.create(
            L, 2, 32, nkv, hd, jnp.bfloat16, head_major=True, tail_r=0),
            jspecs, cfg)
    head = lm_head_f32(tp, tspecs)
    with pytest.raises(NotImplementedError):
        forward(tp, torch.from_numpy(toks),
                KVCache.create(L, 2, 32, nkv, hd, head_major=True,
                               device="cpu"), tspecs, cfg, head_f32=head)
    # a cache no longer than the window serves
    logits, _ = forward(tp, torch.from_numpy(toks),
                        KVCache.create(L, 2, 16, nkv, hd, head_major=True,
                                       device="cpu"),
                        tspecs, cfg, head_f32=head)
    assert bool(torch.isfinite(logits).all())
    # generate's cache (rounded up to 128 slots) passes the window: both
    # engines take the batch-major cache, where the window binds
    ecfg = dict(max_seq_len=64, prefill_chunk=8)
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(device_decode_loop=False,
                                                  **ecfg))
    assert not eng.new_cache(1, 128).head_major
    assert not jeng.new_cache(1, 128).head_major
    prompts = [[3, 9, 27, 81, 5, 15, 45, 7, 21, 63, 11, 33, 99, 2, 6, 18,
                54, 4], [1, 2, 3]]
    assert eng.generate(prompts, NEW) == jeng.generate(prompts, NEW)
    # a uniform window (mistral-style) on a batch-major ring cache: prefill
    # of 20 tokens (the window of 16 binds) and two decode steps
    ucfg = dataclasses.replace(cfg, sliding_window_pattern=1)
    seq = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (2, 22)).astype(np.int32)
    jc = JKVCache.create(L, 2, 64, nkv, hd, jnp.bfloat16)
    tc = KVCache.create(L, 2, 64, nkv, hd, device="cpu")
    for chunk in (seq[:, :20], seq[:, 20:21], seq[:, 21:]):
        jl, jc = j_forward(jp, jnp.asarray(chunk), jc, jspecs, ucfg)
        tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, ucfg,
                         head_f32=head)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())


def test_norms_are_carried_and_made():
    """convert carries every norm scale bit for bit and keeps the head
    tied; the port's own init makes the post-norm scales for gemma2 and
    serves through its engine."""
    cfg, jp, _, tp, tspecs = build(3, None, gemma2_cfg())
    for jb, tb in zip(jp.blocks, tp.blocks):
        for f in NORMS:
            np.testing.assert_array_equal(np.asarray(getattr(jb, f)),
                                          getattr(tb, f).numpy())
    assert tp.lm_head is None and jp.lm_head is None
    params = init_decoder_params(cfg, tspecs,
                                 torch.Generator().manual_seed(7),
                                 device="cpu", outlier_budget=16)
    assert all(b.post_attn_norm_scale is not None
               and b.post_ffw_norm_scale is not None for b in params.blocks)
    out = InferenceEngine(params, cfg, tspecs, EngineConfig(
        max_seq_len=64, prefill_chunk=8, kv_dtype="int8"),
        device="cpu").generate([[1, 2, 3], [4, 5]], 4)
    assert [len(r) for r in out] == [4, 4]
