"""PyTorch port: models/hf.py against mixq_tpu/models/hf.py for the
llama, mistral and gemma2 families.

- config_from_hf: tiny transformers configs (LlamaConfig, MistralConfig,
  Gemma2Config; no weights, nothing downloaded) map to the same ModelConfig
  field for field; other families and scaled rope raise.
- params_from_source: a seeded HF-named state dict (random norm weights,
  so gemma's +1 offset shows; gemma2's four norms and tied head) quantized
  as FP16, W8A8 with planted outlier sets and W4A4 (packed, calibrated-
  style sets) gives every field of DecoderParams bit-equal to JAX's, from a
  numpy dict and from a bf16 torch state dict."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import transformers

from mixq_tpu.config import QuantConfig
from mixq_tpu.models import hf as jhf
from mixq_tpu.models.decoder import DecoderSpecs as JSpecs
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec as JLinearSpec
from mixq_tpu.quantize import resolve_specs as j_resolve_specs
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.models.decoder import DecoderSpecs as TSpecs
from mixq_tpu_torch.ops import quant as TQ
from mixq_tpu_torch.ops.mixed_linear import LinearSpec as TLinearSpec
from mixq_tpu_torch.quantize import resolve_specs as t_resolve_specs

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


def hf_config(family):
    if family == "llama":
        return transformers.LlamaConfig(**TINY).to_dict()
    if family == "mistral":
        return transformers.MistralConfig(sliding_window=16, **TINY).to_dict()
    return transformers.Gemma2Config(
        head_dim=32, sliding_window=32, query_pre_attn_scalar=32,
        **TINY).to_dict()


@pytest.mark.parametrize("family", ["llama", "mistral", "gemma2"])
def test_config_from_hf_as_jax(family):
    d = hf_config(family)
    j, t = jhf.config_from_hf(d), thf.config_from_hf(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model_type == family


@pytest.mark.parametrize("change,err", [
    # families neither package maps (mixtral and qwen2_moe map since the
    # MoE slice: tests/test_torch_moe_models.py)
    ({"model_type": "jamba"}, NotImplementedError),
    ({"model_type": "dbrx"}, NotImplementedError),
    ({"rope_scaling": {"rope_type": "dynamic", "factor": 2.0}},
     ValueError),
    ({"rope_scaling": {"rope_type": "yarn", "factor": 2.0}}, ValueError)])
def test_config_from_hf_raises(change, err):
    with pytest.raises(err):
        thf.config_from_hf({**hf_config("llama"), **change})
    assert thf.config_from_hf(
        {**hf_config("llama"), "rope_scaling": {"rope_type": "default"}})


def hf_state(cfg, seed):
    """A seeded HF-named state dict of float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)

    def w(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def norm():
        return (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)

    d = {"model.embed_tokens.weight": w(V, H, s=0.02),
         "model.norm.weight": norm()}
    if not cfg.tie_word_embeddings:
        d["lm_head.weight"] = w(V, H, s=0.02)
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        d[p + "input_layernorm.weight"] = norm()
        d[p + "post_attention_layernorm.weight"] = norm()
        if cfg.model_type == "gemma2":
            d[p + "pre_feedforward_layernorm.weight"] = norm()
            d[p + "post_feedforward_layernorm.weight"] = norm()
        d[p + "self_attn.q_proj.weight"] = w(nq * hd, H)
        d[p + "self_attn.k_proj.weight"] = w(nkv * hd, H)
        d[p + "self_attn.v_proj.weight"] = w(nkv * hd, H)
        d[p + "self_attn.o_proj.weight"] = w(H, nq * hd)
        d[p + "mlp.gate_proj.weight"] = w(I, H)
        d[p + "mlp.up_proj.weight"] = w(I, H)
        d[p + "mlp.down_proj.weight"] = w(H, I)
    return d


def outlier_sets(cfg, budget, seed):
    """Planted per-layer sets on both sides (the same sorted indices)."""
    rng = np.random.default_rng(seed)
    k_of = {"wqkv": cfg.hidden_size, "up": cfg.hidden_size,
            "wo": cfg.num_attention_heads * cfg.head_dim_,
            "down": cfg.intermediate_size}
    j, t = {}, {}
    for i in range(cfg.num_hidden_layers):
        for slot, k in k_of.items():
            ind = np.sort(rng.choice(k, budget // 2, replace=False))
            key = f"{i}.{slot}"
            j[key] = JQ.outlier_set_from_indices(ind, k, budget)
            t[key] = TQ.outlier_set_from_indices(ind, k, budget,
                                                 device="cpu")
    return j, t


def specs_of(scheme):
    if scheme == "fp16":
        return JSpecs.fp16(), TSpecs.fp16()
    if scheme == "w8a8":
        return (JSpecs.uniform(JLinearSpec(w_bit=8, a_bit=8)),
                TSpecs.uniform(TLinearSpec(w_bit=8, a_bit=8)))
    q = QuantConfig.w4a4(outlier_budget=16)
    return (j_resolve_specs(q),
            t_resolve_specs(TQuantConfig.from_dict(q.to_dict())))


def assert_tree_equal(j, t, path="params"):
    """Every tensor of the port's tree bit-equal (dtype, shape, bits) to
    the JAX tree's field of the same name; None where JAX has None."""
    if t is None:
        assert j is None, path
        return
    if isinstance(t, torch.Tensor):
        a = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert a.dtype.name == "bfloat16", path
            a, b = a.astype(np.float32), t.float().numpy()
        else:
            b = t.numpy()
            assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        for f in t._fields:
            assert_tree_equal(getattr(j, f, None), getattr(t, f),
                              f"{path}.{f}")
        return
    assert len(j) == len(t), path
    for i, (a, b) in enumerate(zip(j, t)):
        assert_tree_equal(a, b, f"{path}[{i}]")


@pytest.mark.parametrize("family", ["llama", "mistral", "gemma2"])
@pytest.mark.parametrize("scheme", ["fp16", "w8a8", "w4a4"])
def test_params_from_source_as_jax(family, scheme):
    cfg = jhf.config_from_hf(hf_config(family))
    tcfg = thf.config_from_hf(hf_config(family))
    state = hf_state(cfg, seed=3)
    jspecs, tspecs = specs_of(scheme)
    josets, tosets = (outlier_sets(cfg, 16, 4) if scheme != "fp16"
                      else (None, None))
    jp = jhf.params_from_source(jhf.TensorSource.from_dict(state), cfg,
                                jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_dict(state), tcfg,
                                tspecs, tosets, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    assert (tp.lm_head is None) == (family == "gemma2")
    assert (tp.blocks[0].post_ffw_norm_scale is None) == (family != "gemma2")
    if scheme == "w4a4":
        assert tp.blocks[0].attn.wq.q_weight.dtype == torch.uint8
    for lin in (tp.blocks[0].attn.wq, tp.blocks[0].mlp.down):
        assert lin.q_weight.is_contiguous()


@pytest.mark.parametrize("family", ["llama", "gemma2"])
def test_from_torch_state_dict_as_jax(family):
    """A bf16 torch state dict, as a model on the card would hold it."""
    cfg = jhf.config_from_hf(hf_config(family))
    tcfg = thf.config_from_hf(hf_config(family))
    sd = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in hf_state(cfg, seed=5).items()}
    jspecs, tspecs = specs_of("w8a8")
    josets, tosets = outlier_sets(cfg, 16, 6)
    jp = jhf.params_from_source(jhf.TensorSource.from_torch_state_dict(sd),
                                cfg, jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_torch_state_dict(sd),
                                tcfg, tspecs, tosets, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)


def test_unported_sources_raise():
    """A family without a scheme raises; the MoE families have theirs
    (llama's attention, the MLP read from the experts), so a dense llama
    dict under an MoE config lacks the expert tensors."""
    cfg = thf.config_from_hf(hf_config("llama"))
    state = hf_state(cfg, 0)
    src = thf.TensorSource.from_dict(state)
    with pytest.raises(NotImplementedError):     # no scheme
        thf.params_from_source(src, dataclasses.replace(
            cfg, model_type="jamba"), TSpecs.fp16(), device="cpu")
    for mt in ("mixtral", "qwen2_moe"):
        assert thf.scheme_for(mt)["q"] == thf.scheme_for("llama")["q"]
        with pytest.raises(KeyError, match=r"\.gate\.weight"):  # router
            thf.params_from_source(src, dataclasses.replace(
                cfg, model_type=mt, num_local_experts=4), TSpecs.fp16(),
                device="cpu")
    assert thf.scheme_for("mistral") is thf.scheme_for("llama")
