"""PyTorch port, the baichuan family (Baichuan-13B: ALiBi in place of
rotary, one fused W_pack q/k/v tensor) on the CPU, against the JAX package.

- config_from_hf: the published config.json of Baichuan-13B-Base (40
  layers: ALiBi, rope style "none") and of Baichuan-7B (32 layers: rotary),
  and a small config with an explicit position_embedding "ALIBI", map to
  the same ModelConfig as JAX's, field for field; chip_smoke.baichuan_13b()
  is that 13B config.
- params_from_source: a seeded state dict under baichuan's HF names (W_pack
  rows [q | k | v], with and without a bias) quantized as FP16, W8A8 with
  planted outlier sets and W4A4 gives every field bit-equal to JAX's, the
  three linears sharing one outlier set.
- A tiny ALiBi model (6 heads: non-power-of-two slopes; MHA as Baichuan),
  W8A8 with planted outliers, quantized by the JAX package and carried
  over by convert.py (a baichuan tree is the llama tree: q/k/v split at
  load): teacher-forced logits against JAX's eager `forward`, a prefill of
  8 then decode steps with left-padding starts, on the batch-major cache
  (kernel 8's plain version, bf16 and int8 KV) and on the head-major one
  (kernel 3's plain version against the Pallas kernel in interpret mode),
  within 5e-3 * max|logits| (tests/test_torch_decoder.py's limit).
- Greedy tokens of `generate` equal JAX's InferenceEngine under "auto"
  (bf16 KV, batch-major) and "flash" (int8 KV, head-major), at a seed
  whose top-2 margins the test asserts (at other seeds the port's tokens
  can equal JAX's eager engine but not its jitted one: JAX's own
  jit-vs-eager spread, ROADMAP.md Queue C).
- The pipeline on a W_pack source of the tiny ALiBi model with embedding
  channel 7 boosted by 10 (tests/test_online.py's outlier model): W8A8
  quantize_model bit-equal to JAX's, then warmup_online_outliers: the
  counts and every promoted parameter equal JAX's, every channel's maximum
  asserted farther from sigma than the two stats forwards differ (JAX's
  runs under jit); calibration's act scales within 2e-2 of each key's max
  of JAX's (tests/test_torch_quantize_pipeline.py's limit) and W4A4
  quantize_model from the same scales bit-equal.
"""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import ModelConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models import hf as jhf
from mixq_tpu.config import QuantConfig
from mixq_tpu.models.decoder import DecoderSpecs as JSpecs
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu.quantize import calibration as jcal
from mixq_tpu.quantize import quantize_model as j_quantize_model
from mixq_tpu.quantize.online import warmup_online_outliers as j_warmup
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.decoder import DecoderSpecs as TSpecs
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.quantize import calibration as tcal
from mixq_tpu_torch.quantize import quantize_model, warmup_online_outliers

import test_torch_models as models
from test_torch_hf_source import (assert_tree_equal, hf_state,
                                  outlier_sets, specs_of)
from test_torch_online import j_stats

# the published config.json of baichuan-inc/Baichuan-13B-Base and of
# baichuan-inc/Baichuan-7B (the fields config_from_hf reads)
BAICHUAN_13B = dict(model_type="baichuan", vocab_size=64000,
                    hidden_size=5120, intermediate_size=13696,
                    num_hidden_layers=40, num_attention_heads=40,
                    model_max_length=4096, rms_norm_eps=1e-6,
                    hidden_act="silu", tie_word_embeddings=False)
BAICHUAN_7B = dict(model_type="baichuan", vocab_size=64000, hidden_size=4096,
                   intermediate_size=11008, num_hidden_layers=32,
                   num_attention_heads=32, max_position_embeddings=4096,
                   rms_norm_eps=1e-6, hidden_act="silu",
                   tie_word_embeddings=False)
TINY = dict(model_type="baichuan", vocab_size=256, hidden_size=192,
            intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=6, max_position_embeddings=128)
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
GREEDY_SEED = 5


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("hf,alibi", [
    (BAICHUAN_13B, True), (BAICHUAN_7B, False),
    ({**TINY, "position_embedding": "ALIBI"}, True), (TINY, False)])
def test_config_from_hf_as_jax(hf, alibi):
    j, t = jhf.config_from_hf(hf), thf.config_from_hf(hf)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.alibi is alibi
    assert t.rope_style == ("none" if alibi else "neox")
    if hf is BAICHUAN_13B:
        assert t == _chip_smoke().baichuan_13b()


def baichuan_state(cfg, seed, bias):
    """hf_state's llama dict with each layer's q/k/v fused into W_pack
    (rows [q | k | v]), with a seeded bias when `bias`."""
    d = hf_state(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}.self_attn."
        parts = [d.pop(p + f"{n}_proj.weight") for n in "qkv"]
        d[p + "W_pack.weight"] = np.concatenate(parts, axis=0)
        if bias:
            d[p + "W_pack.bias"] = (0.1 * rng.standard_normal(
                sum(x.shape[0] for x in parts))).astype(np.float32)
    return d


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("scheme", ["fp16", "w8a8", "w4a4"])
def test_w_pack_params_bit_equal_to_jax(scheme, bias):
    cfg = thf.config_from_hf({**TINY, "num_key_value_heads": 2})
    state = baichuan_state(cfg, seed=3, bias=bias)
    jspecs, tspecs = specs_of(scheme)
    josets, tosets = (outlier_sets(cfg, 16, 4) if scheme != "fp16"
                      else (None, None))
    jp = jhf.params_from_source(jhf.TensorSource.from_dict(state), cfg,
                                jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_dict(state), cfg,
                                tspecs, tosets, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    attn = tp.blocks[0].attn
    assert (attn.wq.bias is not None) is bias
    if scheme != "fp16":
        assert attn.wq.out_ind is attn.wk.out_ind is attn.wv.out_ind
    # and from a bf16 torch state dict
    sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in state.items()}
    jp = jhf.params_from_source(jhf.TensorSource.from_torch_state_dict(sd),
                                cfg, jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_torch_state_dict(sd),
                                cfg, tspecs, tosets, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)


def alibi_cfg() -> ModelConfig:
    """A tiny Baichuan-13B: ALiBi, rope style "none", 6 heads of 32, MHA."""
    return ModelConfig.tiny(model_type="baichuan", alibi=True,
                            rope_style="none", hidden_size=192,
                            intermediate_size=256, num_attention_heads=6,
                            num_key_value_heads=6)


def build(seed, attn_impl):
    cfg, jp, jspecs, tp, tspecs = models.build(seed, cfg=alibi_cfg())
    return (cfg, jp, dataclasses.replace(jspecs, attn_impl=attn_impl), tp,
            dataclasses.replace(tspecs, attn_impl=attn_impl))


@pytest.mark.parametrize("kv_dtype,head_major", [
    ("bfloat16", False), ("int8", False), ("bfloat16", True),
    ("int8", True)])
def test_tiny_alibi_logits_vs_jax(kv_dtype, head_major):
    cfg, jp, jspecs, tp, tspecs = build(2, "flash" if head_major else "auto")
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (3, 14)).astype(np.int32)
    kv_start = np.array([0, 2, 5], np.int32)
    chunks = [toks[:, :8]] + [toks[:, i:i + 1] for i in range(8, 14)]
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    jc = JKVCache.create(L, 3, 32, nkv, hd, jnp.dtype(kv_dtype),
                         head_major=head_major,
                         **({"tail_r": 0} if head_major else {}))
    tc = KVCache.create(L, 3, 32, nkv, hd, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    head = lm_head_f32(tp, tspecs)
    no_bias = dataclasses.replace(cfg, alibi=False, rope_style="neox")
    moved = 0.0
    for chunk in chunks:
        jl, jc = j_forward(jp, jnp.asarray(chunk), jc, jspecs, cfg,
                           jnp.asarray(kv_start))
        tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, cfg,
                         torch.from_numpy(kv_start), head_f32=head)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())
        if chunk is chunks[0]:          # the bias matters on this model
            rope_c = KVCache.create(L, 3, 32, nkv, hd,
                                    getattr(torch, kv_dtype),
                                    head_major=head_major, device="cpu")
            other, _ = forward(tp, torch.from_numpy(chunk), rope_c, tspecs,
                               no_bias, torch.from_numpy(kv_start),
                               head_f32=head)
            moved = np.abs(other.numpy() - jl).max() / np.abs(jl).max()
    assert moved > 5e-2
    assert tc.head_major is head_major and tc.host_length == 14


@pytest.mark.parametrize("attn_impl,kv_dtype", [("auto", "bfloat16"),
                                                ("flash", "int8")])
def test_greedy_tokens_match_jax(attn_impl, kv_dtype):
    cfg, jp, jspecs, tp, tspecs = build(GREEDY_SEED, attn_impl)
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(device_decode_loop=False,
                                                  **ecfg))
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    head_major = attn_impl == "flash"
    assert eng.new_cache(1, 128).head_major is head_major
    assert jeng.new_cache(1, 128).head_major is head_major
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
    logits, cache = eng.prefill(padded, cache, kv_start)
    for step in range(NEW):
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 5e-3 * logits.abs().max().item(), (step, margin)
        if step + 1 < NEW:
            logits, cache = eng.decode_step(toks[:, step:step + 1], cache,
                                            kv_start)


def test_pipeline_on_a_w_pack_source_as_jax():
    hf = {**TINY, "position_embedding": "ALIBI"}
    cfg, tcfg = jhf.config_from_hf(hf), thf.config_from_hf(hf)
    state = baichuan_state(tcfg, seed=6, bias=False)
    state["model.embed_tokens.weight"][:, 7] += 10.0
    jsrc = jhf.TensorSource.from_dict(state)
    tsrc = thf.TensorSource.from_dict(state)
    batches = [np.random.RandomState(s).randint(0, cfg.vocab_size, (2, 16))
               for s in range(2)]
    qcfg = QuantConfig.w8a8(outlier_budget=16)
    tq = TQuantConfig.from_dict(qcfg.to_dict())
    jp, jspecs = j_quantize_model(jsrc, cfg, qcfg)
    tp, tspecs = quantize_model(tsrc, tcfg, tq, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    log = []
    tw, tcounts = warmup_online_outliers(tp, tcfg, tspecs, batches,
                                         stats_log=log)
    jw, jcounts = j_warmup(jp, cfg, jspecs, batches)
    assert tcounts == jcounts and sum(tcounts.values()) > 0
    assert_tree_equal(jax.tree.map(np.asarray, jw), tw)
    wq = tw.blocks[0].attn.wq
    assert 7 in wq.out_ind[:int(wq.out_count)].tolist()
    # no channel within the stats' spread of sigma on the first step
    js = j_stats(jp, jspecs, cfg, batches[0])
    spread = max(np.abs(log[0][k].numpy() - js[k]).max() for k in js)
    margin = min(np.abs(log[0][k].numpy() - 6.0).min() for k in js)
    assert margin > spread, (margin, spread)
    # calibration on the ALiBi model, then W4A4 from the same scales
    jscales = jcal.collect_act_scales(
        jhf.params_from_source(jsrc, cfg, JSpecs.fp16()), cfg, batches)
    tscales = tcal.collect_act_scales(
        thf.params_from_source(tsrc, tcfg, TSpecs.fp16(), device="cpu"),
        tcfg, batches)
    for k, v in jscales.items():
        assert (np.abs(np.asarray(tscales[k]) - v).max()
                <= 2e-2 * np.abs(v).max()), k
    q4 = QuantConfig.w4a4(outlier_budget=16)
    jp4, _ = j_quantize_model(jsrc, cfg, q4, act_scales=jscales)
    tp4, _ = quantize_model(tsrc, tcfg, TQuantConfig.from_dict(
        q4.to_dict()), act_scales=jscales, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp4), tp4)
