"""PyTorch port, the sparse-MoE families (mixtral, and qwen2_moe with its
shared expert and raw top-k weights) on the CPU, against the JAX package.

Each family is a tiny HF config made by transformers' own config class and
a seeded HF-named state dict from transformers' own model class (norms and
biases moved off their init values by seeded noise, as
tests/test_torch_families.py makes them): H 64, 2 heads of 32 (mixtral on
one kv head), 4 experts of 64 or 128, 2 layers.

- config_from_hf field for field as JAX's, both presets as JAX maps their
  published configs, and qwen2_moe's dense layers refused as JAX refuses
  them.
- params_from_source through both packages, FP16 and W8A8 with planted
  attention outlier sets: every field bit-equal (the stacked experts, the
  router, the shared expert and its gate), and convert.py's carry of
  JAX's params equal to the port's own load.
- Teacher-forced logits, a prefill of 8 then 4 decode steps with
  left-padding starts, weights carried from JAX by convert.py: FP16 on the
  batch-major bf16 cache and W8A8O16 on the head-major int8 cache, against
  JAX's eager `forward`, within 5e-3 * max|logits| (tests/
  test_torch_decoder.py's limit).
- Greedy tokens of `generate` (W8A8O16) equal JAX's InferenceEngine's
  under "auto" (bf16 KV) and "flash" (int8 KV), each step's top-2 margin
  asserted above 5e-3 * max|logits| at the seeds taken.
- Checkpoints saved by either package load bit-equal in the other.
- Calibration statistics on the MoE blocks equal JAX's ("down" is the
  MLP input, as JAX reports it).
- quantize_model (W8A8) then InferenceEngine.warmup_online: the MoE blocks'
  experts take no outlier set, the attention's sets and every promoted
  parameter equal JAX's, and the warmed engines' greedy tokens are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import QuantConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models import hf as jhf
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu.quantize import checkpoint as jck
from mixq_tpu.quantize import quantize_model as j_quantize_model
from mixq_tpu_torch import presets
from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.quantize import checkpoint as tck
from mixq_tpu_torch.quantize import quantize_model

from test_torch_checkpoint import (assert_bit_equal_to_jax,
                                   assert_port_bit_equal,
                                   greedy_with_margins)
from test_torch_hf_source import assert_tree_equal, outlier_sets, specs_of
from test_torch_substrate import one_thread  # noqa: F401

TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=256)
FAMILIES = {
    "mixtral": (transformers.MixtralConfig, transformers.MixtralForCausalLM,
                dict(TINY, intermediate_size=128, num_key_value_heads=1,
                     num_local_experts=4, num_experts_per_tok=2)),
    "qwen2_moe": (transformers.Qwen2MoeConfig,
                  transformers.Qwen2MoeForCausalLM,
                  dict(TINY, intermediate_size=128, num_key_value_heads=2,
                       moe_intermediate_size=64,
                       shared_expert_intermediate_size=128, num_experts=4,
                       num_experts_per_tok=2, norm_topk_prob=False,
                       decoder_sparse_step=1, mlp_only_layers=[])),
}
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6


def hf_model(family, seed):
    """(HF config dict, HF-named f32 numpy state dict): transformers'
    init, then every norm scale and bias moved by seeded noise."""
    cfg_cls, model_cls, kw = FAMILIES[family]
    config = cfg_cls(**kw)
    torch.manual_seed(seed)
    model = model_cls(config).eval()
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = v.detach().float().numpy().copy()
        if k.endswith("norm.weight") or k.endswith(".bias"):
            a = a + (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        sd[k] = a
    return config.to_dict(), sd


def build(family, seed, precision):
    """(JAX cfg, port cfg, JAX params, JAX specs, port params, port specs):
    FP16, or W8A8 with planted attention sets, through each package's
    params_from_source."""
    d, sd = hf_model(family, seed)
    jcfg, tcfg = jhf.config_from_hf(d), thf.config_from_hf(d)
    jspecs, tspecs = specs_of(precision)
    josets, tosets = (outlier_sets(tcfg, 16, seed + 4)
                      if precision != "fp16" else (None, None))
    jp = jhf.params_from_source(jhf.TensorSource.from_dict(sd), jcfg,
                                jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_dict(sd), tcfg,
                                tspecs, tosets, device="cpu")
    return jcfg, tcfg, jp, jspecs, tp, tspecs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_as_jax(family):
    d, _ = hf_model(family, 0)
    j, t = jhf.config_from_hf(d), thf.config_from_hf(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.num_local_experts == 4 and t.num_experts_per_tok == 2
    assert t.moe_norm_topk is (family == "mixtral")
    assert t.attention_bias is (family == "qwen2_moe")


@pytest.mark.parametrize("preset", ["mixtral_8x7b", "qwen1_5_moe_a2_7b"])
def test_presets_as_jax_maps_them(preset, monkeypatch):
    """Each preset is its published config through config_from_hf: the
    JAX package maps the same dict to the same fields."""
    seen = {}
    real = thf.config_from_hf
    monkeypatch.setattr(thf, "config_from_hf",
                        lambda hf: seen.setdefault("hf", hf) and real(hf))
    cfg = getattr(presets, preset)()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jhf.config_from_hf(seen["hf"]))
    if preset == "mixtral_8x7b":
        assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts,
                cfg.num_experts_per_tok, cfg.num_key_value_heads,
                cfg.sliding_window) == (4096, 14336, 8, 2, 8, None)
    else:
        assert (cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts,
                cfg.num_experts_per_tok, cfg.moe_norm_topk,
                cfg.attention_bias) == (2048, 1408, 60, 4, False, True)


@pytest.mark.parametrize("change", [{"decoder_sparse_step": 2},
                                    {"mlp_only_layers": [1]}])
def test_qwen2_moe_dense_layers_refused(change):
    d, _ = hf_model("qwen2_moe", 0)
    for mod in (jhf, thf):
        with pytest.raises(ValueError, match="dense layers"):
            mod.config_from_hf({**d, **change})


@pytest.mark.parametrize("scheme", ["fp16", "w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_bit_equal_to_jax(family, scheme):
    jcfg, tcfg, jp, _, tp, _ = build(family, 0, scheme)
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    moe = tp.blocks[1].mlp.moe
    assert tp.blocks[1].mlp.up is None and moe is not None
    assert tuple(moe.gate.q_weight.shape) == (4, 64, tcfg.intermediate_size)
    assert tuple(moe.down.q_weight.shape) == (4, tcfg.intermediate_size, 64)
    assert moe.router.dtype == torch.bfloat16
    assert (moe.shared_up is not None) is (family == "qwen2_moe")
    if family == "qwen2_moe":
        assert tuple(moe.shared_route.shape) == (64, 1)
        assert tuple(moe.shared_up.q_weight.shape) == (64, 128)
    # convert.py carries JAX's params to the port's own load, bit for bit
    carried = decoder_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert_port_bit_equal(carried, tp)


@pytest.mark.parametrize("precision,kv_dtype,head_major", [
    ("fp16", "bfloat16", False), ("w8a8", "int8", True)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_teacher_forced_logits_vs_jax(family, precision, kv_dtype,
                                      head_major):
    cfg, tcfg, jp, jspecs, _, tspecs = build(family, 1, precision)
    tp = decoder_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (3, 12)).astype(np.int32)
    kv_start = np.array([0, 2, 5], np.int32)
    chunks = [toks[:, :8]] + [toks[:, i:i + 1] for i in range(8, 12)]
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    jc = JKVCache.create(L, 3, 32, nkv, hd, jnp.dtype(kv_dtype),
                         head_major=head_major,
                         **({"tail_r": 0} if head_major else {}))
    tc = KVCache.create(L, 3, 32, nkv, hd, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    head = lm_head_f32(tp, tspecs)
    for chunk in chunks:
        jl, jc = j_forward(jp, jnp.asarray(chunk), jc, jspecs, cfg,
                           jnp.asarray(kv_start))
        with torch.inference_mode():
            tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, tcfg,
                             torch.from_numpy(kv_start), head_f32=head)
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).max() < 5e-3 * np.abs(jl).max()


# the seed of each family's weights: one whose top-2 margins clear the
# limit under both policies (asserted)
GREEDY_SEED = {"mixtral": 4, "qwen2_moe": 1}


@pytest.mark.parametrize("attn_impl,kv_dtype", [("auto", "bfloat16"),
                                                ("flash", "int8")])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_tokens_match_jax(family, attn_impl, kv_dtype):
    cfg, tcfg, jp, jspecs, tp, tspecs = build(family, GREEDY_SEED[family],
                                              "w8a8")
    jspecs = dataclasses.replace(jspecs, attn_impl=attn_impl)
    tspecs = dataclasses.replace(tspecs, attn_impl=attn_impl)
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(device_decode_loop=False,
                                                  **ecfg))
    eng = InferenceEngine(tp, tcfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    assert eng.new_cache(1, 128).head_major is (attn_impl == "flash")
    assert greedy_with_margins(eng, PROMPTS, NEW) == jeng.generate(PROMPTS,
                                                                   NEW)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_checkpoints_each_way_bit_equal(family, tmp_path):
    cfg, tcfg, jp, _, tp, _ = build(family, 2, "w8a8")
    qcfg = QuantConfig.w8a8(outlier_budget=16)
    tq = TQuantConfig.from_dict(qcfg.to_dict())
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(dj, jp, cfg, qcfg)
    tck.save_checkpoint(dt, tp, tcfg, tq)
    names = [n for n, _ in tck._leaf_paths(tp)]
    assert "blocks.1.mlp.moe.down.w_scale" in names
    assert ("blocks.0.mlp.moe.shared_route" in names) is (
        family == "qwen2_moe")
    got, mcfg, q2 = tck.load_checkpoint(dj, device="cpu")
    assert mcfg == tcfg and q2 == tq
    assert_port_bit_equal(got, tp)
    assert_bit_equal_to_jax(got, jp)
    jgot, jcfg, jq = jck.load_checkpoint(dt)
    assert jcfg == cfg and jq == qcfg
    assert_bit_equal_to_jax(tp, jgot)


# the seed of each warmed model: one whose top-2 margins clear the limit
# (asserted)
WARM_SEED = {"mixtral": 1, "qwen2_moe": 0}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_warmup_online_as_jax(family):
    """W8A8 (empty sets, budget 16) from the HF dict, with embedding
    channel 7 boosted so that warmup promotes it: after each package's
    warmup_online the params are bit-equal (the MoE MLPs untouched: no
    outlier set on an expert), the counts equal, and generate's greedy
    tokens equal."""
    d, sd = hf_model(family, WARM_SEED[family])
    sd["model.embed_tokens.weight"][:, 7] *= 40.0
    jcfg, tcfg = jhf.config_from_hf(d), thf.config_from_hf(d)
    qcfg = QuantConfig.w8a8(outlier_budget=16)
    jp, jspecs = j_quantize_model(jhf.TensorSource.from_dict(sd), jcfg, qcfg)
    tp, tspecs = quantize_model(thf.TensorSource.from_dict(sd), tcfg,
                                TQuantConfig.from_dict(qcfg.to_dict()),
                                device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    batches = [np.random.RandomState(s).randint(0, 256, (2, 16))
               for s in range(2)]
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype="bfloat16")
    jeng = JEngine(jp, jcfg, jspecs, JEngineConfig(device_decode_loop=False,
                                                   **ecfg))
    eng = InferenceEngine(tp, tcfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    jcounts = jeng.warmup_online(batches)
    counts = eng.warmup_online(batches)
    assert counts == jcounts
    assert all(f"{i}.up" not in counts and f"{i}.down" not in counts
               for i in range(2))
    assert counts["0.wqkv"] > 0
    assert_tree_equal(jax.tree.map(np.asarray, jeng.params), eng.params)
    assert eng.params.blocks[0].mlp.moe is tp.blocks[0].mlp.moe
    assert greedy_with_margins(eng, PROMPTS, NEW) == jeng.generate(PROMPTS,
                                                                   NEW)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_calibration_stats_as_jax(family):
    """collect_act_scales on the FP16 MoE model: JAX's keys, each
    channel's max within 1e-2 of the key's max|stat| from JAX's jitted run
    (tests/test_torch_collect_stats.py's limit: the stats are maxima of
    bf16 activations, one of which an f32 sum in another order can round
    an ulp apart, as some of the MLP input's channels read here); an MoE
    block reports its MLP input as "down" too (JAX's decoder.py:185-188),
    so the two are equal."""
    from mixq_tpu.quantize.calibration import collect_act_scales as j_collect
    from mixq_tpu_torch.quantize.calibration import collect_act_scales

    jcfg, tcfg, jp, _, tp, _ = build(family, 0, "fp16")
    batches = [np.random.RandomState(s).randint(0, 256, (2, 16))
               for s in range(2)]
    j = j_collect(jp, jcfg, batches)
    t = collect_act_scales(tp, tcfg, batches)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), j[k], rtol=0,
                                   atol=1e-2 * np.abs(j[k]).max(), err_msg=k)
    for i in range(tcfg.num_hidden_layers):
        assert torch.equal(t[f"{i}.up"], t[f"{i}.down"])
