"""PyTorch port, the LayerNorm families (falcon: MQA, the new decoder,
ALiBi; gptj; opt; starcoder2) and chatglm on the CPU, against the JAX
package.

Each family is a tiny HF config made by transformers' own config class (as
tests/test_hf_parity.py:320-370 builds them) and a seeded HF-named state
dict from transformers' own model class, its norms and biases moved off
their init values by seeded noise; chatglm, which transformers does not
ship, is a dict under its checkpoint names (as
tests/test_fused_qkv_sources.py:67-95 builds it). falcon and starcoder2
take 9 query heads on one kv head (g = 9, StarCoder2-7B's group), chatglm
16 (ChatGLM3-6B's), falcon's new decoder 16 on 2 (an interleaved
query_key_value at g = 8).

- config_from_hf through both packages equal, field for field; OPT's
  word_embed_proj_dim refused by both; the five presets equal JAX's
  mapping of the same published dicts (chatglm's depth and context aside:
  JAX's mapping does not read `num_layers` / `seq_length`).
- params_from_source through both packages, FP16 and W8A8 with planted
  outlier sets: every field bit-equal (falcon's interleaved
  query_key_value, chatglm's packed dense_h_to_4h and qkv bias, OPT's
  positions without their +2 offset, every LayerNorm bias and lnf_bias).
- layernorm within 4 f32 ulps of the row's scale of JAX's (its mean and
  variance summed in another order: 3 read), a bf16 ulp once rounded;
  gptj-style apply_rope within an f32 ulp of JAX's on the same tables.
- GPT-J's HF head bias: neither package reads it (ROADMAP.md Queue C).
- Checkpoints of the falcon and OPT models, saved by either package, load
  bit-equal in the other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from mixq_tpu.config import QuantConfig
from mixq_tpu.models import hf as jhf
from mixq_tpu.models import layers as JL
from mixq_tpu.quantize import checkpoint as jck
from mixq_tpu_torch import presets
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.models import layers as TL
from mixq_tpu_torch.quantize import checkpoint as tck

from test_torch_checkpoint import (assert_bit_equal_to_jax,
                                   assert_port_bit_equal)
from test_torch_hf_source import assert_tree_equal, outlier_sets, specs_of

TINY = dict(vocab_size=256, num_hidden_layers=2, max_position_embeddings=64)
FAMILIES = {
    # Falcon-7B's shape: MQA, the parallel block on one LayerNorm, GELU;
    # 9 heads of 16 on one kv head
    "falcon": (transformers.FalconConfig, transformers.FalconForCausalLM,
               dict(TINY, hidden_size=144, num_attention_heads=9,
                    multi_query=True, parallel_attn=True, bias=False,
                    new_decoder_architecture=False, alibi=False)),
    # Falcon-40B's new decoder: ln_attn and ln_mlp, 16 heads on 2 kv heads
    "falcon_new": (transformers.FalconConfig, transformers.FalconForCausalLM,
                   dict(TINY, hidden_size=256, num_attention_heads=16,
                        num_kv_heads=2, parallel_attn=True, bias=False,
                        new_decoder_architecture=True, alibi=False)),
    # falcon's ALiBi (slopes pre-scaled by 1/sqrt(head_dim)), with biases
    "falcon_alibi": (transformers.FalconConfig,
                     transformers.FalconForCausalLM,
                     dict(TINY, hidden_size=96, num_attention_heads=6,
                          multi_query=True, parallel_attn=True, bias=True,
                          new_decoder_architecture=False, alibi=True)),
    "gptj": (transformers.GPTJConfig, transformers.GPTJForCausalLM,
             dict(vocab_size=256, n_embd=64, n_layer=2, n_head=4,
                  rotary_dim=8, n_positions=64)),
    "opt": (transformers.OPTConfig, transformers.OPTForCausalLM,
            dict(TINY, hidden_size=64, ffn_dim=128, num_attention_heads=4,
                 do_layer_norm_before=True, activation_function="relu",
                 word_embed_proj_dim=64)),
    # StarCoder2-7B's g = 9, biases on every linear and norm
    "starcoder2": (transformers.Starcoder2Config,
                   transformers.Starcoder2ForCausalLM,
                   dict(TINY, hidden_size=144, intermediate_size=256,
                        num_attention_heads=9, num_key_value_heads=1,
                        use_bias=True)),
    # ChatGLM3-6B's g = 16: 16 heads of 16 in one multi-query group
    "chatglm": None,
}
CHATGLM = dict(model_type="chatglm", padded_vocab_size=256, hidden_size=256,
               ffn_hidden_size=192, kv_channels=16, num_hidden_layers=2,
               num_attention_heads=16, multi_query_attention=True,
               multi_query_group_num=1, layernorm_epsilon=1e-5,
               tie_word_embeddings=False)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread (tests/test_torch_substrate.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def chatglm_dict(seed):
    """chatglm's checkpoint names: a fused query_key_value with its bias,
    dense_h_to_4h packed [gate; up], RMSNorm scales, an untied head."""
    rng = np.random.default_rng(seed)
    H, I, V = (CHATGLM["hidden_size"], CHATGLM["ffn_hidden_size"],
               CHATGLM["padded_vocab_size"])
    hd = CHATGLM["kv_channels"]
    qkv = (CHATGLM["num_attention_heads"]
           + 2 * CHATGLM["multi_query_group_num"]) * hd

    def w(*shape, std=0.05):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    p = "transformer.encoder."
    sd = {"transformer.embedding.word_embeddings.weight": w(V, H, std=1.0),
          p + "final_layernorm.weight": 1 + w(H, std=0.1),
          "transformer.output_layer.weight": w(V, H)}
    for i in range(CHATGLM["num_hidden_layers"]):
        q = f"{p}layers.{i}."
        sd.update({
            q + "input_layernorm.weight": 1 + w(H, std=0.1),
            q + "post_attention_layernorm.weight": 1 + w(H, std=0.1),
            q + "self_attention.query_key_value.weight": w(qkv, H),
            q + "self_attention.query_key_value.bias": w(qkv, std=0.1),
            q + "self_attention.dense.weight": w(H, H),
            q + "mlp.dense_h_to_4h.weight": w(2 * I, H),
            q + "mlp.dense_4h_to_h.weight": w(H, I)})
    return sd


def hf_model(family, seed):
    """(HF config dict, HF-named f32 numpy state dict) of a seeded tiny
    model of `family`: transformers' init, then every norm scale and bias
    moved by seeded noise (a head bias, GPT-J's, by a large one)."""
    if family == "chatglm":
        return dict(CHATGLM), chatglm_dict(seed)
    cfg_cls, model_cls, kw = FAMILIES[family]
    config = cfg_cls(**kw)
    torch.manual_seed(seed)
    model = model_cls(config).eval()
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        a = v.detach().float().numpy().copy()
        if k == "lm_head.bias":
            a = a + rng.standard_normal(a.shape).astype(np.float32)
        elif "norm" in k or "ln" in k or k.endswith(".bias"):
            a = a + (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        sd[k] = a
    return config.to_dict(), sd


def configs(family, seed=0):
    d, sd = hf_model(family, seed)
    return jhf.config_from_hf(d), thf.config_from_hf(d), sd


def build(family, seed, precision):
    """(JAX cfg, port cfg, JAX params, JAX specs, port params, port specs)
    of the family's model in FP16, or W8A8O16 with planted sets."""
    jcfg, tcfg, sd = configs(family, seed)
    jspecs, tspecs = specs_of(precision)
    josets, tosets = (outlier_sets(tcfg, 16, seed + 4)
                      if precision != "fp16" else (None, None))
    jp = jhf.params_from_source(jhf.TensorSource.from_dict(sd), jcfg,
                                jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_dict(sd), tcfg,
                                tspecs, tosets, device="cpu")
    return jcfg, tcfg, jp, jspecs, tp, tspecs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_from_hf_equal_to_jax(family):
    jcfg, tcfg, _ = configs(family)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    g = tcfg.num_attention_heads // tcfg.num_key_value_heads
    assert g == {"falcon": 9, "falcon_new": 8, "falcon_alibi": 6, "gptj": 1,
                 "opt": 1, "starcoder2": 9, "chatglm": 16}[family]
    assert tcfg.layernorm == ("rmsnorm" if family == "chatglm"
                              else "layernorm")


def test_opt_word_embed_proj_dim_refused_by_both():
    d, _ = hf_model("opt", 0)
    d = dict(d, word_embed_proj_dim=32)
    for mod in (jhf, thf):
        with pytest.raises(ValueError, match="word_embed_proj_dim"):
            mod.config_from_hf(d)


@pytest.mark.parametrize("preset,hf", [
    ("falcon_7b", dict(model_type="falcon", vocab_size=65024,
                       hidden_size=4544, num_hidden_layers=32,
                       num_attention_heads=71, multi_query=True,
                       new_decoder_architecture=False, parallel_attn=True,
                       alibi=False, bias=False, layer_norm_epsilon=1e-5)),
    ("gptj_6b", dict(model_type="gptj", vocab_size=50400, n_embd=4096,
                     n_layer=28, n_head=16, n_inner=None, n_positions=2048,
                     rotary_dim=64, activation_function="gelu_new")),
    ("opt_6_7b", dict(model_type="opt", vocab_size=50272, hidden_size=4096,
                      ffn_dim=16384, num_hidden_layers=32,
                      num_attention_heads=32, max_position_embeddings=2048,
                      activation_function="relu", word_embed_proj_dim=4096)),
    ("starcoder2_7b", dict(model_type="starcoder2", vocab_size=49152,
                           hidden_size=4608, intermediate_size=18432,
                           num_hidden_layers=32, num_attention_heads=36,
                           num_key_value_heads=4,
                           max_position_embeddings=16384, norm_epsilon=1e-5,
                           rope_theta=1000000, sliding_window=4096,
                           use_bias=True)),
    ("chatglm3_6b", dict(model_type="chatglm", padded_vocab_size=65024,
                         hidden_size=4096, ffn_hidden_size=13696,
                         kv_channels=128, num_layers=28,
                         num_attention_heads=32, multi_query_attention=True,
                         multi_query_group_num=2, layernorm_epsilon=1e-5,
                         seq_length=8192)),
])
def test_presets_are_jax_mappings_of_the_published_configs(preset, hf):
    got = dataclasses.asdict(getattr(presets, preset)())
    want = dataclasses.asdict(jhf.config_from_hf(hf))
    if preset == "chatglm3_6b":
        # JAX's mapping reads neither num_layers nor seq_length
        assert (want["num_hidden_layers"], want["max_position_embeddings"]
                ) == (32, 4096)
        want.update(num_hidden_layers=28, max_position_embeddings=8192)
    assert got == want
    g = got["num_attention_heads"] // got["num_key_value_heads"]
    assert g == {"falcon_7b": 71, "gptj_6b": 1, "opt_6_7b": 1,
                 "starcoder2_7b": 9, "chatglm3_6b": 16}[preset]


@pytest.mark.parametrize("scheme", ["fp16", "w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_bit_equal_to_jax(family, scheme):
    _, tcfg, jp, _, tp, _ = build(family, 0, scheme)
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    b = tp.blocks[0]
    ln = tcfg.layernorm == "layernorm"
    assert (b.ln1_bias is not None) is ln
    assert (tp.lnf_bias is not None) is ln
    assert (b.ln2_scale is None) is (family in ("falcon", "falcon_alibi",
                                                "gptj"))
    assert (b.mlp.gate is None) is (family != "chatglm")
    assert (tp.pos_embed is not None) is (family == "opt")
    if family == "opt":
        assert tp.pos_embed.shape[0] == tcfg.max_position_embeddings
    assert (b.attn.wq.bias is not None) is (family in (
        "falcon_alibi", "opt", "starcoder2", "chatglm"))
    if scheme != "fp16":
        assert b.attn.wq.out_ind is b.attn.wk.out_ind is b.attn.wv.out_ind


@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 7, 144), (2, 3, 4544)])
def test_layernorm_within_ulps_of_jax(shape):
    rng = np.random.default_rng(shape[-1])
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    scale = rng.normal(1.0, 0.1, shape[-1]).astype(np.float32)
    bias = rng.normal(0.0, 0.1, shape[-1]).astype(np.float32)
    for b in (bias, None):
        for dt, jdt in ((torch.float32, jnp.float32),
                        (torch.bfloat16, jnp.bfloat16)):
            ref = np.asarray(JL.layernorm(
                jnp.asarray(x, jdt), jnp.asarray(scale),
                None if b is None else jnp.asarray(b), 1e-5), np.float32)
            got = TL.layernorm(torch.from_numpy(x).to(dt),
                               torch.from_numpy(scale),
                               None if b is None else torch.from_numpy(b),
                               1e-5).float().numpy()
            err = np.abs(got - ref)
            if dt == torch.float32:
                # the mean and the variance summed in another order than
                # XLA's: a few f32 ulps of the row's scale (3 read here)
                row = np.abs(ref).max(-1, keepdims=True)
                assert (err <= 4 * np.spacing(row)).all()
            else:
                # then rounded to bf16: at most a flip of one bf16 ulp
                assert (err <= 2.0 ** -7 * np.abs(ref)).all()


@pytest.mark.parametrize("rot,D", [(8, 16), (16, 16), (64, 128)])
def test_gptj_rope_within_an_ulp_of_jax(rot, D):
    rng = np.random.default_rng(rot + D)
    x = rng.normal(0, 1, (2, 5, 3, D)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), rot, 10000.0)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), rot, 10000.0)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ref = np.asarray(JL.apply_rope(jnp.asarray(x, jdt), jc, js, "gptj",
                                       rot), np.float32)
        # the same tables on both sides (XLA's and PyTorch's cos/sin may
        # differ by an ulp), then the port's own
        got = TL.apply_rope(torch.from_numpy(x).to(dt),
                            torch.from_numpy(np.array(jc)),
                            torch.from_numpy(np.array(js)), "gptj",
                            rot).float().numpy()
        own = TL.apply_rope(torch.from_numpy(x).to(dt), tc, ts, "gptj",
                            rot).float().numpy()
        ulp = 2.0 ** -23 if dt == torch.float32 else 2.0 ** -7
        assert (np.abs(got - ref) <= ulp * np.abs(ref) + 1e-7).all()
        assert (np.abs(own - ref) <= 4 * ulp * np.abs(ref) + 1e-6).all()
        if dt == torch.float32:          # past rot, values pass through
            assert (got[..., rot:] == x[..., rot:]).all()


def test_gptj_head_bias_is_not_read():
    """GPT-J's HF head has a bias, which JAX's scheme (and so the port's)
    does not read: both give the bias-free head, and the port's FP16
    logits sit nearer HF's logits less the bias than HF's own (ROADMAP.md
    Queue C)."""
    cfg, tcfg, jp, _, tp, tspecs = build("gptj", 3, "fp16")
    _, sd = hf_model("gptj", 3)
    assert "lm_head.bias" in sd
    np.testing.assert_array_equal(np.asarray(jp.lm_head, np.float32),
                                  tp.lm_head.float().numpy())
    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.layers import KVCache
    toks = torch.tensor([[5, 17, 33, 2, 9, 40]])
    cache = KVCache.create(2, 1, 16, cfg.num_key_value_heads, cfg.head_dim_,
                           torch.bfloat16, device="cpu")
    got = forward(tp, toks, cache, tspecs, tcfg,
                  head_f32=lm_head_f32(tp, tspecs))[0][0].numpy()
    hf_cls, model_cls, kw = FAMILIES["gptj"]
    model = model_cls(hf_cls(**kw)).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=False)
    with torch.no_grad():
        ref = model(toks).logits[0].numpy()
    bias = sd["lm_head.bias"]
    assert (np.abs(got - (ref - bias)).max()
            < 0.1 * np.abs(got - ref).max())


@pytest.mark.parametrize("family", ["falcon", "opt"])
def test_checkpoints_each_way_bit_equal(family, tmp_path):
    cfg, tcfg, jp, _, tp, _ = build(family, 2, "w8a8")
    qcfg = QuantConfig.w8a8(outlier_budget=16)
    tq = TQuantConfig.from_dict(qcfg.to_dict())
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(dj, jp, cfg, qcfg)
    tck.save_checkpoint(dt, tp, tcfg, tq)
    got, mcfg, q2 = tck.load_checkpoint(dj, device="cpu")
    assert mcfg == tcfg and q2 == tq
    assert_port_bit_equal(got, tp)
    assert_bit_equal_to_jax(got, jp)
    jgot, jcfg, jq = jck.load_checkpoint(dt)
    assert jcfg == cfg and jq == qcfg
    assert_bit_equal_to_jax(tp, jgot)
    b = got.blocks[1]
    assert b.ln1_bias is not None and got.lnf_bias is not None
    assert b.mlp.gate is None
    if family == "opt":
        assert got.pos_embed is not None and b.attn.wq.bias is not None
    else:
        assert b.ln2_scale is None
