"""PyTorch port, the RMSNorm families (qwen2 with q/k/v bias, qwen3 with
QK-norm, phi3 with packed weights, head dim 96, partial rotary and
longrope, gemma, llama with Llama-3.1's llama3 rope scaling) on the CPU,
against the JAX package.

Each family is a tiny HF config made by transformers' own config class
(as tests/test_hf_parity.py:45-60 builds them) and a seeded HF-named
state dict from transformers' own model class (its norms, biases and
QK-norm scales moved off their init values by seeded noise). qwen2 takes
7 query heads on one kv head (g = 7, Qwen2.5-7B's group), phi3 2 heads of
96 (Phi-3's head dim).

- params_from_source through both packages, FP16 and W8A8 with planted
  outlier sets (q/k/v sharing one, gate/up another): every field
  bit-equal (phi3's qkv_proj and gate_up_proj split at load, qwen2's bias,
  qwen3's q_norm / k_norm, gemma's (1 + w) norms and tied head).
- (tests/test_torch_families_logits.py) Teacher-forced logits, a
  prefill of 8 then 6 decode steps with
  left-padding starts: FP16 on the batch-major bf16 cache (kernel 8's
  plain version at T = 1) and W8A8O16 on the head-major int8 cache
  (kernel 3's plain version, against JAX's Pallas flash kernel in
  interpret mode), against JAX's eager `forward`, within 5e-3 *
  max|logits| (tests/test_torch_decoder.py's limit) or, on the int8
  cache, within the gap between JAX's own jitted and eager forwards on
  the same run if that is larger: an exp() ulp flips a probability level
  of kernel 3's int8 recipe now and then, and more so on qwen3, whose
  QK-norm peaks the softmax (its run reads 1.2e-2 against JAX's own
  1.6e-2).
- (tests/test_torch_families_generate.py) Greedy tokens of `generate`
  (W8A8O16) equal JAX's InferenceEngine's,
  under "auto" with bf16 KV (batch-major) and under "flash" with int8 KV
  (head-major), each step's top-2 margin asserted above 5e-3 *
  max|logits| at the seeds taken.
- Checkpoints of the qwen2 (bias) and qwen3 (QK-norm) models, saved by
  either package, load bit-equal in the other.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import transformers

from mixq_tpu.config import QuantConfig
from mixq_tpu.models import hf as jhf
from mixq_tpu.quantize import checkpoint as jck
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.quantize import checkpoint as tck

from test_torch_checkpoint import (assert_bit_equal_to_jax,
                                   assert_port_bit_equal)
from test_torch_hf_source import assert_tree_equal, outlier_sets, specs_of

TINY = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
ROPE = dict(max_position_embeddings=512, original_max_position_embeddings=64)
FAMILIES = {
    # Qwen2.5-7B's group: 7 query heads of 32 on one kv head
    "qwen2": (transformers.Qwen2Config, transformers.Qwen2ForCausalLM,
              dict(TINY, hidden_size=224, num_attention_heads=7,
                   num_key_value_heads=1)),
    "qwen3": (transformers.Qwen3Config, transformers.Qwen3ForCausalLM,
              dict(TINY, head_dim=32)),
    # Phi-3's head dim: 2 heads of 96
    "phi3": (transformers.Phi3Config, transformers.Phi3ForCausalLM,
             dict(TINY, hidden_size=192, num_attention_heads=2,
                  num_key_value_heads=2, pad_token_id=0)),
    # Phi-4-mini-class: rope on 3/4 of each head, "su" longrope factors
    "phi3_partial_longrope": (
        transformers.Phi3Config, transformers.Phi3ForCausalLM,
        dict(TINY, **ROPE, pad_token_id=0, partial_rotary_factor=0.75,
             rope_scaling={"type": "su",
                           "short_factor": [1.0 + 0.2 * i
                                            for i in range(12)],
                           "long_factor": [2.0 + 0.4 * i
                                           for i in range(12)]})),
    "gemma": (transformers.GemmaConfig, transformers.GemmaForCausalLM,
              dict(TINY, head_dim=32, hidden_act="gelu")),
    "llama3": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
               dict(TINY, rope_scaling={
                   "rope_type": "llama3", "factor": 8.0,
                   "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                   "original_max_position_embeddings": 16})),
}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread (tests/test_torch_substrate.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hf_model(family, seed):
    """(HF config dict, HF-named f32 numpy state dict) of a seeded tiny
    model of `family`: transformers' init, then every norm scale, bias
    and QK-norm scale moved by seeded noise (gemma's (1 + w) norms start
    at w = 0, HF's other norms at 1)."""
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


def configs(family, seed=0):
    d, sd = hf_model(family, seed)
    return jhf.config_from_hf(d), thf.config_from_hf(d), sd


@pytest.mark.parametrize("scheme", ["fp16", "w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_params_bit_equal_to_jax(family, scheme):
    jcfg, tcfg, sd = configs(family)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jspecs, tspecs = specs_of(scheme)
    josets, tosets = (outlier_sets(tcfg, 16, 4) if scheme != "fp16"
                      else (None, None))
    jp = jhf.params_from_source(jhf.TensorSource.from_dict(sd), jcfg,
                                jspecs, josets)
    tp = thf.params_from_source(thf.TensorSource.from_dict(sd), tcfg,
                                tspecs, tosets, device="cpu")
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    attn, mlp = tp.blocks[0].attn, tp.blocks[0].mlp
    assert (attn.wq.bias is not None) is (family == "qwen2")
    assert (attn.q_norm is not None) is (family == "qwen3")
    assert mlp.gate.q_weight.shape == mlp.up.q_weight.shape
    assert (tp.lm_head is None) is (family == "gemma")
    if scheme != "fp16":
        assert attn.wq.out_ind is attn.wk.out_ind is attn.wv.out_ind
        assert mlp.gate.out_ind is mlp.up.out_ind


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


@pytest.mark.parametrize("family", ["qwen2", "qwen3"])
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
    a = got.blocks[1].attn
    if family == "qwen2":
        assert a.wq.bias is not None and a.wv.bias is not None
    else:
        assert a.q_norm is not None and a.k_norm is not None
