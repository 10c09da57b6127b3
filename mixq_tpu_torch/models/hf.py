"""HuggingFace weights into the port's DecoderParams (mirrors
mixq_tpu/models/hf.py).

    cfg = config_from_hf(hf_config_dict)
    src = TensorSource.from_torch_state_dict(model.state_dict())
    params = params_from_source(src, cfg, specs, outlier_sets, device=...)

    params, cfg = load_model(hf_dir, specs, device="cuda")

Ported: `TensorSource` over a dict, a torch state dict or an HF
safetensors directory (read by the port's own utils/safetensors_io.py),
`config_from_hf` with HF's linear, llama3 and (phi3) longrope rope
scaling, `load_hf_config`, `load_model`, and the weight-name schemes of
the families (PORTED_FAMILIES: the RMSNorm ones, llama, aquila,
baichuan, mistral, qwen2, qwen3, phi3, gemma, gemma2, and the LayerNorm
ones, falcon, gptj, opt, starcoder2, with chatglm, and the sparse-MoE
ones, mixtral and qwen2_moe), and `params_from_source` for their blocks
(separate q/k/v with qwen2's or starcoder2's bias, or baichuan's fused
`W_pack`, phi3's `qkv_proj` and chatglm's `query_key_value` (with its
bias) split at load, falcon's `query_key_value` interleaved per kv
group; phi3's `gate_up_proj` and chatglm's `dense_h_to_4h` split gate
first; qwen3's q_norm / k_norm; gated or plain MLPs with their biases;
LayerNorm biases, falcon's `input_layernorm` or `ln_attn` and `ln_mlp`;
OPT's learned positions without their +2 offset; gemma's +1 norm offset;
gemma2's post-norms; a tied head; an MoE block's router and experts,
each expert's [N, K] weights stacked [E, K, N] and quantized per
(expert, out-channel), and qwen2-moe's shared expert and its sigmoid
gate). Every weight is quantized where its tensor lies or on `device`: a
state dict on the card is quantized on the card, one tensor at a time,
never through numpy; a tensor goes to `device` in its stored dtype and
is widened there. Yarn, dynamic and other rope scalings raise
ValueError, as in JAX, and so does a qwen2_moe config with dense layers
(mlp_only_layers, decoder_sparse_step != 1). As JAX, no scheme reads an
`lm_head.bias` (GPT-J's HF head has one; ROADMAP.md Queue C).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.models.decoder import (AttnParams, BlockParams,
                                           DecoderParams, DecoderSpecs,
                                           MLPParams)
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                             from_float)
from mixq_tpu_torch.ops.moe import MoEParams, expert_from_float
from mixq_tpu_torch.utils.safetensors_io import SafeTensorsFile

PORTED_FAMILIES = ("llama", "aquila", "baichuan", "mistral", "qwen2",
                   "qwen3", "phi3", "gemma", "gemma2", "falcon", "gptj",
                   "opt", "chatglm", "starcoder2", "mixtral", "qwen2_moe")


# ---------------------------------------------------------------------------
# Config mapping
# ---------------------------------------------------------------------------

def rope_scaling_kw(hf: Dict) -> Dict:
    """HF `rope_scaling` -> ModelConfig fields (JAX's rope_scaling_kw,
    mixq_tpu/models/hf.py:49-72): "linear" and "llama3" map; "default" and
    None pass through; any other type (yarn, dynamic NTK) raises
    ValueError rather than compute wrong positions. phi3's longrope is
    config_from_hf's own branch."""
    rs = hf.get("rope_scaling") or None
    if not rs:
        return {}
    rtype = rs.get("rope_type", rs.get("type", "default"))
    if rtype == "default":
        return {}
    if rtype == "linear":
        return {"rope_scaling_type": "linear",
                "rope_scaling_factor": float(rs["factor"])}
    if rtype == "llama3":
        return {
            "rope_scaling_type": "llama3",
            "rope_scaling_factor": float(rs["factor"]),
            "rope_low_freq_factor": float(rs["low_freq_factor"]),
            "rope_high_freq_factor": float(rs["high_freq_factor"]),
            "rope_original_max_position": int(
                rs["original_max_position_embeddings"]),
        }
    raise ValueError(f"unsupported rope_scaling type {rtype!r}")


def _phi3_rope_kw(hf: Dict, common: Dict) -> Dict:
    """phi3's partial rotary factor and longrope (or its legacy alias
    "su") as JAX maps them (mixq_tpu/models/hf.py:105-140): the attention
    factor from the config, else sqrt(1 + ln(max_pos / orig) / ln(orig))
    when the context is extended."""
    import math

    kw = {}
    head_dim = common["hidden_size"] // common["num_attention_heads"]
    prf = float(hf.get("partial_rotary_factor", 1.0))
    if prf < 1.0:
        kw["rotary_dim"] = int(head_dim * prf)
    rs = hf.get("rope_scaling") or None
    if rs and rs.get("rope_type", rs.get("type")) in ("longrope", "su"):
        orig = int(hf.get("original_max_position_embeddings",
                          common["max_position_embeddings"]))
        factor = common["max_position_embeddings"] / orig
        att = rs.get("attention_factor")
        if att is None:
            att = (1.0 if factor <= 1.0 else
                   math.sqrt(1 + math.log(factor) / math.log(orig)))
        kw.update({
            "rope_scaling_type": "longrope",
            "rope_short_factor": tuple(float(f) for f in rs["short_factor"]),
            "rope_long_factor": tuple(float(f) for f in rs["long_factor"]),
            "rope_original_max_position": orig,
            "rope_attention_factor": float(att)})
    elif rs:
        kw.update(rope_scaling_kw(hf))
    return kw


def config_from_hf(hf: Dict) -> ModelConfig:
    """Map an HF config dict to ModelConfig, field for field as JAX's
    config_from_hf does, for PORTED_FAMILIES."""
    mt = hf.get("model_type", "llama")
    if mt not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"config_from_hf: model_type {mt!r} is not ported (have: "
            f"{', '.join(PORTED_FAMILIES)})")
    common = dict(
        model_type=mt,
        vocab_size=hf.get("vocab_size", 32000),
        hidden_size=hf.get("hidden_size", hf.get("n_embd", 4096)),
        num_hidden_layers=hf.get("num_hidden_layers", hf.get("n_layer", 32)),
        num_attention_heads=hf.get("num_attention_heads",
                                   hf.get("n_head", 32)),
        max_position_embeddings=hf.get(
            "max_position_embeddings", hf.get("n_positions", 4096)),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )
    if mt in _LAYERNORM_CONFIGS:
        return _LAYERNORM_CONFIGS[mt](hf, common)
    if mt == "qwen2_moe":
        return _qwen2_moe(hf, common)
    common["intermediate_size"] = hf["intermediate_size"]
    n_kv = hf.get("num_key_value_heads", common["num_attention_heads"])
    if mt == "qwen3":
        return ModelConfig(
            **common,
            num_key_value_heads=n_kv,
            head_dim=hf.get("head_dim"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 1e6),
            attention_bias=hf.get("attention_bias", False),
            sliding_window=(hf.get("sliding_window")
                            if hf.get("use_sliding_window", False) else None),
            qk_norm=True,
            **rope_scaling_kw(hf),
        )
    if mt == "mixtral":
        # JAX's mapping (mixq_tpu/models/hf.py:163-176)
        return ModelConfig(
            **common,
            num_key_value_heads=n_kv,
            head_dim=hf.get("head_dim"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 1e6),
            sliding_window=hf.get("sliding_window"),
            num_local_experts=hf.get("num_local_experts", 8),
            num_experts_per_tok=hf.get("num_experts_per_tok", 2),
            **rope_scaling_kw(hf),
        )
    if mt == "phi3":
        return ModelConfig(
            **common,
            num_key_value_heads=n_kv,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            sliding_window=hf.get("sliding_window"),
            **_phi3_rope_kw(hf, common),
        )
    if mt == "gemma":
        # llama naming; sqrt(hidden) embedding scale, GeGLU MLP, (1 + w)
        # norms (folded at load), explicit head_dim, always a tied head;
        # hidden_act before the deprecated hidden_activation, as the
        # installed transformers' GemmaMLP reads them (JAX's rule,
        # mixq_tpu/models/hf.py:224-245)
        return ModelConfig(
            **{**common, "tie_word_embeddings": True},
            num_key_value_heads=n_kv,
            head_dim=hf.get("head_dim", 256),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            hidden_act=hf.get("hidden_act")
            or hf.get("hidden_activation") or "gelu_pytorch_tanh",
            embed_multiplier=float(common["hidden_size"]) ** 0.5,
            gated_mlp=True,
            **rope_scaling_kw(hf),
        )
    if mt == "gemma2":
        return ModelConfig(
            **{**common, "tie_word_embeddings": True},
            num_key_value_heads=n_kv,
            head_dim=hf.get("head_dim", 256),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            rope_theta=hf.get("rope_theta", 10000.0),
            hidden_act=hf.get("hidden_activation",
                              "gelu_pytorch_tanh") or "gelu_pytorch_tanh",
            embed_multiplier=float(common["hidden_size"]) ** 0.5,
            gated_mlp=True,
            post_norms=True,
            query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar", 256)),
            attn_logit_softcap=hf.get("attn_logit_softcapping"),
            final_logit_softcap=hf.get("final_logit_softcapping"),
            sliding_window=hf.get("sliding_window", 4096),
            sliding_window_pattern=2,   # even layers local, odd global
            **rope_scaling_kw(hf),
        )
    # llama, aquila, baichuan, mistral, qwen2 (qwen2: q/k/v bias).
    # Baichuan-13B takes ALiBi in place of rotary: JAX's rule
    # (mixq_tpu/models/hf.py:177-200), 40 layers or an explicit
    # position_embedding "ALIBI"
    alibi = mt == "baichuan" and (
        common["num_hidden_layers"] == 40
        or str(hf.get("position_embedding", "")).upper() == "ALIBI")
    return ModelConfig(
        **common,
        num_key_value_heads=n_kv,
        head_dim=hf.get("head_dim"),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        hidden_act=hf.get("hidden_act", "silu"),
        attention_bias=(mt == "qwen2") or hf.get("attention_bias", False),
        sliding_window=(hf.get("sliding_window")
                        if hf.get("use_sliding_window", mt == "mistral")
                        else None),
        alibi=alibi,
        rope_style="none" if alibi else "neox",
        **rope_scaling_kw(hf),
    )


def _qwen2_moe(hf: Dict, common: Dict) -> ModelConfig:
    """qwen2_moe as JAX maps it (mixq_tpu/models/hf.py:144-162): the
    experts' moe_intermediate_size, q/k/v bias, the raw top-k weights
    unless norm_topk_prob; dense layers raise ValueError."""
    if hf.get("mlp_only_layers") or hf.get("decoder_sparse_step", 1) != 1:
        raise ValueError(
            "qwen2_moe with dense layers (mlp_only_layers / "
            "decoder_sparse_step != 1) is not supported yet")
    return ModelConfig(
        **common,
        intermediate_size=hf.get("moe_intermediate_size", 1408),
        num_key_value_heads=hf.get("num_key_value_heads",
                                   common["num_attention_heads"]),
        head_dim=hf.get("head_dim"),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 1e6),
        attention_bias=True,
        num_local_experts=hf.get("num_experts", 60),
        num_experts_per_tok=hf.get("num_experts_per_tok", 4),
        moe_norm_topk=hf.get("norm_topk_prob", False),
        **rope_scaling_kw(hf),
    )


def _starcoder2(hf: Dict, common: Dict) -> ModelConfig:
    """JAX's starcoder2 mapping (mixq_tpu/models/hf.py:89-104): LayerNorm,
    use_bias on every linear, a plain MLP of gelu_pytorch_tanh."""
    return ModelConfig(
        **common,
        intermediate_size=hf["intermediate_size"],
        num_key_value_heads=hf.get("num_key_value_heads",
                                   common["num_attention_heads"]),
        rms_norm_eps=hf.get("norm_epsilon", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        hidden_act=hf.get("hidden_act", "gelu_pytorch_tanh"),
        attention_bias=hf.get("use_bias", True),
        mlp_bias=hf.get("use_bias", True),
        layernorm="layernorm",
        sliding_window=(hf.get("sliding_window")
                        if hf.get("use_sliding_window", False) else None),
        **rope_scaling_kw(hf),
    )


def _falcon(hf: Dict, common: Dict) -> ModelConfig:
    """JAX's falcon mapping (mixq_tpu/models/hf.py:246-261): MQA
    (multi_query) or the new decoder's num_kv_heads, the parallel block,
    GELU without a gate, ALiBi (rope style "none") or rotary."""
    n_head = common["num_attention_heads"]
    alibi = hf.get("alibi", False)
    return ModelConfig(
        **common,
        intermediate_size=hf.get("ffn_hidden_size",
                                 4 * common["hidden_size"]),
        num_key_value_heads=(hf.get("num_kv_heads", n_head)
                             if hf.get("new_decoder_architecture", False)
                             else (1 if hf.get("multi_query", True)
                                   else n_head)),
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        rope_theta=hf.get("rope_theta", 10000.0),
        hidden_act="gelu",
        layernorm="layernorm",
        parallel_attn_mlp=hf.get("parallel_attn", True),
        alibi=alibi,
        rope_style="none" if alibi else "neox",
    )


def _gptj(hf: Dict, common: Dict) -> ModelConfig:
    """JAX's gptj mapping (mixq_tpu/models/hf.py:262-275): the parallel
    block, gptj-style RoPE on rotary_dim, gelu_new."""
    return ModelConfig(
        **common,
        intermediate_size=hf.get("n_inner") or 4 * common["hidden_size"],
        num_key_value_heads=common["num_attention_heads"],
        rms_norm_eps=hf.get("layer_norm_epsilon", 1e-5),
        hidden_act=("gelu_new"
                    if hf.get("activation_function", "gelu_new")
                    in ("gelu_new", "gelu_pytorch_tanh") else "gelu"),
        layernorm="layernorm",
        parallel_attn_mlp=True,
        rope_style="gptj",
        rotary_dim=hf.get("rotary_dim", 64),
    )


def _opt(hf: Dict, common: Dict) -> ModelConfig:
    """JAX's opt mapping (mixq_tpu/models/hf.py:276-292): learned
    positions (rope style "none"), relu or GELU; a word_embed_proj_dim
    other than hidden_size (project_in / project_out) raises ValueError."""
    wepd = hf.get("word_embed_proj_dim", hf.get("hidden_size", 768))
    if wepd != hf.get("hidden_size", 768):
        raise ValueError(
            "OPT variants with word_embed_proj_dim != hidden_size "
            "(project_in/project_out, e.g. opt-350m) are not supported")
    common = dict(common, hidden_size=hf.get("hidden_size", 768))
    return ModelConfig(
        **common,
        intermediate_size=hf.get("ffn_dim", 3072),
        num_key_value_heads=common["num_attention_heads"],
        hidden_act={"gelu": "gelu", "gelu_new": "gelu_new"}.get(
            hf.get("activation_function", "relu"), "relu"),
        layernorm="layernorm",
        rope_style="none",
    )


def _chatglm(hf: Dict, common: Dict) -> ModelConfig:
    """JAX's chatglm mapping (mixq_tpu/models/hf.py:293-308): RMSNorm,
    multi-query groups, SwiGLU, gptj-style RoPE on half of kv_channels,
    theta scaled by rope_ratio."""
    common = dict(common, vocab_size=hf.get("padded_vocab_size",
                                            hf.get("vocab_size", 65024)))
    return ModelConfig(
        **common,
        intermediate_size=hf["ffn_hidden_size"],
        num_key_value_heads=(hf.get("multi_query_group_num",
                                    common["num_attention_heads"])
                             if hf.get("multi_query_attention", False)
                             else common["num_attention_heads"]),
        rms_norm_eps=hf.get("layernorm_epsilon", 1e-5),
        hidden_act="silu",
        rope_style="gptj",
        rotary_dim=hf.get("kv_channels", 128) // 2,
        rope_theta=10000.0 * hf.get("rope_ratio", 1.0),
    )


_LAYERNORM_CONFIGS = {"starcoder2": _starcoder2, "falcon": _falcon,
                      "gptj": _gptj, "opt": _opt, "chatglm": _chatglm}


# ---------------------------------------------------------------------------
# State-dict access + name schemes
# ---------------------------------------------------------------------------

class TensorSource:
    """Uniform tensor access: `get(name)` gives a torch tensor (where it
    lies; numpy arrays become CPU tensors), `has(name)` whether it
    exists."""

    def __init__(self, get: Callable[[str], torch.Tensor],
                 has: Callable[[str], bool]):
        self.get = get
        self.has = has

    @classmethod
    def from_dict(cls, d: Dict) -> "TensorSource":
        """Over a dict of numpy arrays or torch tensors."""
        def get(k):
            v = d[k]
            return (v if isinstance(v, torch.Tensor)
                    else tensor_from_numpy(v, device="cpu"))
        return cls(get, lambda k: k in d)

    @classmethod
    def from_torch_state_dict(cls, sd) -> "TensorSource":
        """Over a torch state dict; the tensors stay on their device."""
        return cls(lambda k: sd[k].detach(), lambda k: k in sd)

    @classmethod
    def from_safetensors_dir(cls, path: str, device="cpu") -> "TensorSource":
        """Over an HF checkpoint directory: the shards that
        `model.safetensors.index.json` names, or one `model.safetensors`.
        `get` maps a shard at its first use and reads one tensor onto
        `device` in its stored dtype (bf16 stays bf16: JAX's uint16 shift
        to f32 is the same exact widening, done where the tensor lands)."""
        index_file = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index_file):
            with open(index_file) as f:
                shard_of: Dict[str, str] = json.load(f)["weight_map"]
        elif os.path.exists(os.path.join(path, "model.safetensors")):
            with SafeTensorsFile(os.path.join(path, "model.safetensors")) as f:
                shard_of = dict.fromkeys(f.keys(), "model.safetensors")
        else:
            raise FileNotFoundError(f"no safetensors found in {path}")
        handles: Dict[str, SafeTensorsFile] = {}

        def get(k):
            shard = shard_of[k]
            if shard not in handles:
                handles[shard] = SafeTensorsFile(os.path.join(path, shard))
            return handles[shard].get(k, device)

        return cls(get, lambda k: k in shard_of)


_LLAMA = dict(
    embed="model.embed_tokens.weight",
    ln1="model.layers.{i}.input_layernorm.weight",
    q="model.layers.{i}.self_attn.q_proj",
    k="model.layers.{i}.self_attn.k_proj",
    v="model.layers.{i}.self_attn.v_proj",
    qkv=None,
    o="model.layers.{i}.self_attn.o_proj",
    gate="model.layers.{i}.mlp.gate_proj",
    up="model.layers.{i}.mlp.up_proj",
    down="model.layers.{i}.mlp.down_proj",
    ln2="model.layers.{i}.post_attention_layernorm.weight",
    lnf="model.norm.weight",
    lm_head="lm_head.weight",
)
_SCHEMES: Dict[str, Dict[str, Optional[str]]] = {
    "llama": _LLAMA,
    "aquila": _LLAMA,
    "mistral": _LLAMA,
    # qwen2's q/k/v bias is read beside each weight
    "qwen2": _LLAMA,
    "qwen3": dict(_LLAMA, q_norm="model.layers.{i}.self_attn.q_norm.weight",
                  k_norm="model.layers.{i}.self_attn.k_norm.weight"),
    # llama naming, a tied head (JAX's scheme, mixq_tpu/models/hf.py:473)
    "gemma": _LLAMA,
    # q|k|v packed, split by rows at load; gate|up packed, gate first
    # (mixq_tpu/models/hf.py:504-517)
    "phi3": dict(_LLAMA, q=None, k=None, v=None,
                 qkv="model.layers.{i}.self_attn.qkv_proj", gate=None,
                 up="model.layers.{i}.mlp.gate_up_proj",
                 packed_gate_up=True),
    # one fused [q | k | v] tensor (JAX's scheme, mixq_tpu/models/hf.py:
    # 384-396)
    "baichuan": dict(_LLAMA, q=None, k=None, v=None,
                     qkv="model.layers.{i}.self_attn.W_pack"),
    # gemma2's block has four norms: HF's post_attention_layernorm is a
    # post-attention (pre-residual) norm there, unlike llama's pre-MLP one
    "gemma2": dict(
        _LLAMA,
        ln2="model.layers.{i}.pre_feedforward_layernorm.weight",
        post_attn="model.layers.{i}.post_attention_layernorm.weight",
        post_ffw="model.layers.{i}.post_feedforward_layernorm.weight",
    ),
}


# The LayerNorm families and chatglm (JAX's schemes, mixq_tpu/models/hf.py:
# 397-463, 486-503). A tuple names alternatives, the first present read
# (falcon-7b's input_layernorm, the new decoder's ln_attn).
_SCHEMES["falcon"] = dict(
    embed="transformer.word_embeddings.weight",
    ln1=("transformer.h.{i}.input_layernorm.weight",
         "transformer.h.{i}.ln_attn.weight"),
    ln1_bias=("transformer.h.{i}.input_layernorm.bias",
              "transformer.h.{i}.ln_attn.bias"),
    ln2="transformer.h.{i}.ln_mlp.weight",
    ln2_bias="transformer.h.{i}.ln_mlp.bias",
    q=None, k=None, v=None,
    qkv="transformer.h.{i}.self_attention.query_key_value",
    o="transformer.h.{i}.self_attention.dense",
    gate=None,
    up="transformer.h.{i}.mlp.dense_h_to_4h",
    down="transformer.h.{i}.mlp.dense_4h_to_h",
    lnf="transformer.ln_f.weight",
    lnf_bias="transformer.ln_f.bias",
    lm_head="lm_head.weight",
)
_SCHEMES["gptj"] = dict(
    embed="transformer.wte.weight",
    ln1="transformer.h.{i}.ln_1.weight",
    ln1_bias="transformer.h.{i}.ln_1.bias",
    q="transformer.h.{i}.attn.q_proj",
    k="transformer.h.{i}.attn.k_proj",
    v="transformer.h.{i}.attn.v_proj",
    qkv=None,
    o="transformer.h.{i}.attn.out_proj",
    gate=None,
    up="transformer.h.{i}.mlp.fc_in",
    down="transformer.h.{i}.mlp.fc_out",
    ln2=None,
    lnf="transformer.ln_f.weight",
    lnf_bias="transformer.ln_f.bias",
    lm_head="lm_head.weight",
)
_SCHEMES["chatglm"] = dict(
    embed="transformer.embedding.word_embeddings.weight",
    ln1="transformer.encoder.layers.{i}.input_layernorm.weight",
    q=None, k=None, v=None,
    qkv="transformer.encoder.layers.{i}.self_attention.query_key_value",
    o="transformer.encoder.layers.{i}.self_attention.dense",
    gate=None,               # gate|up packed in dense_h_to_4h, gate first
    up="transformer.encoder.layers.{i}.mlp.dense_h_to_4h",
    down="transformer.encoder.layers.{i}.mlp.dense_4h_to_h",
    ln2="transformer.encoder.layers.{i}.post_attention_layernorm.weight",
    lnf="transformer.encoder.final_layernorm.weight",
    lm_head="transformer.output_layer.weight",
    packed_gate_up=True,
)
_SCHEMES["opt"] = dict(
    embed="model.decoder.embed_tokens.weight",
    pos_embed="model.decoder.embed_positions.weight",
    ln1="model.decoder.layers.{i}.self_attn_layer_norm.weight",
    ln1_bias="model.decoder.layers.{i}.self_attn_layer_norm.bias",
    q="model.decoder.layers.{i}.self_attn.q_proj",
    k="model.decoder.layers.{i}.self_attn.k_proj",
    v="model.decoder.layers.{i}.self_attn.v_proj",
    qkv=None,
    o="model.decoder.layers.{i}.self_attn.out_proj",
    gate=None,
    up="model.decoder.layers.{i}.fc1",
    down="model.decoder.layers.{i}.fc2",
    ln2="model.decoder.layers.{i}.final_layer_norm.weight",
    ln2_bias="model.decoder.layers.{i}.final_layer_norm.bias",
    lnf="model.decoder.final_layer_norm.weight",
    lnf_bias="model.decoder.final_layer_norm.bias",
    lm_head="lm_head.weight",
)
_SCHEMES["starcoder2"] = dict(
    embed="model.embed_tokens.weight",
    ln1="model.layers.{i}.input_layernorm.weight",
    ln1_bias="model.layers.{i}.input_layernorm.bias",
    q="model.layers.{i}.self_attn.q_proj",
    k="model.layers.{i}.self_attn.k_proj",
    v="model.layers.{i}.self_attn.v_proj",
    qkv=None,
    o="model.layers.{i}.self_attn.o_proj",
    gate=None,                               # plain GELU MLP (c_fc/c_proj)
    up="model.layers.{i}.mlp.c_fc",
    down="model.layers.{i}.mlp.c_proj",
    ln2="model.layers.{i}.post_attention_layernorm.weight",
    ln2_bias="model.layers.{i}.post_attention_layernorm.bias",
    lnf="model.norm.weight",
    lnf_bias="model.norm.bias",
    lm_head="lm_head.weight",
)


# the MoE families: llama's attention and norms; the MLP is read by
# params_from_source's MoE branch (_moe_from_src)
_SCHEMES["mixtral"] = dict(_LLAMA, gate=None, up=None, down=None)
_SCHEMES["qwen2_moe"] = _SCHEMES["mixtral"]
# each MoE family's MLP prefix and expert weight names (gate, up, down)
_MOE_NAMES = {
    "mixtral": ("model.layers.{i}.block_sparse_moe", ("w1", "w3", "w2")),
    "qwen2_moe": ("model.layers.{i}.mlp",
                  ("gate_proj", "up_proj", "down_proj")),
}


def scheme_for(model_type: str) -> Dict[str, Optional[str]]:
    if model_type not in _SCHEMES:
        raise NotImplementedError(
            f"no weight scheme for model_type {model_type!r} in the port "
            f"(have: {', '.join(PORTED_FAMILIES)})")
    return _SCHEMES[model_type]


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------

def _f32(src: TensorSource, name: str, device) -> torch.Tensor:
    # to the device in the stored dtype, widened there (a host-to-card copy
    # that converts would widen on the host)
    return src.get(name).to(device).to(torch.float32)


def _linear_from_src(src: TensorSource, prefix: str, spec: LinearSpec,
                     oset: Optional[Q.OutlierSet], device) -> MixLinearParams:
    """One HF Linear ([N, K] weight, optional bias) quantized as `spec`
    into [K, N] MixLinearParams (bf16 storage)."""
    w = _f32(src, prefix + ".weight", device).t().contiguous()
    bias = (_f32(src, prefix + ".bias", device)
            if src.has(prefix + ".bias") else None)
    return from_float(w, spec, bias=bias, outlier_set=oset)


def _qkv_from_src(src: TensorSource, scheme, i: int, cfg: ModelConfig,
                  spec: LinearSpec, oset: Optional[Q.OutlierSet], device):
    """(wq, wk, wv), sharing one outlier set (they share one quantized
    activation): from separate q/k/v tensors (with qwen2's bias), or from
    a fused tensor (JAX's _qkv_from_src, mixq_tpu/models/hf.py:550-609):
    falcon's at g > 1 interleaved per kv group, rows [(q_0..q_g-1, k, v)
    x n_kv]; otherwise [q | k | v] (baichuan's W_pack, phi3's qkv_proj,
    chatglm's query_key_value) split by rows at n_q*hd and n_q*hd +
    n_kv*hd; a bias likewise."""
    if not scheme.get("qkv"):
        return tuple(_linear_from_src(src, scheme[n].format(i=i), spec,
                                      oset, device) for n in ("q", "k", "v"))
    prefix = scheme["qkv"].format(i=i)
    w = _f32(src, prefix + ".weight", device)
    bias = (_f32(src, prefix + ".bias", device)
            if src.has(prefix + ".bias") else None)
    hd = cfg.head_dim_
    n_q, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
    if cfg.model_type == "falcon" and n_kv < n_q:
        g = n_q // n_kv

        def groups(t):                 # [n_kv * (g + 2) * hd, ...]
            t = t.reshape(n_kv, g + 2, hd, *t.shape[1:])
            return (t[:, :g].reshape(n_q * hd, *t.shape[3:]),
                    t[:, g].reshape(n_kv * hd, *t.shape[3:]),
                    t[:, g + 1].reshape(n_kv * hd, *t.shape[3:]))
        ws = groups(w)
        bs = groups(bias) if bias is not None else (None,) * 3
        return tuple(from_float(wp.t().contiguous(), spec, bias=bp,
                                outlier_set=oset)
                     for wp, bp in zip(ws, bs))
    sizes = [n_q * hd, n_kv * hd, n_kv * hd]
    ws = torch.split(w, sizes, dim=0)
    bs = torch.split(bias, sizes, dim=0) if bias is not None else (None,) * 3
    return tuple(from_float(wp.t().contiguous(), spec, bias=bp,
                            outlier_set=oset) for wp, bp in zip(ws, bs))


def _moe_from_src(src: TensorSource, cfg: ModelConfig, specs: DecoderSpecs,
                  i: int, device) -> MoEParams:
    """Block i's sparse MoE as JAX reads it (mixq_tpu/models/hf.py:
    652-708): the router `.gate` [E, H] transposed to [H, E] and each
    expert's [N, K] weights stacked [E, K, N] (mixtral's w1/w3/w2 as gate,
    up, down; qwen2-moe's gate_proj/up_proj/down_proj), quantized as
    specs.gate, specs.up and specs.down; qwen2-moe's shared expert (its
    gate and up as specs.up, down as specs.down, no outlier sets) and its
    gate `shared_expert_gate` [1, H] as shared_route [H, 1]; router and
    shared_route in bf16 (JAX's store dtype)."""
    pre, names = _MOE_NAMES[cfg.model_type]
    pre = pre.format(i=i)

    def stack(name):
        return torch.stack([
            _f32(src, f"{pre}.experts.{e}.{name}.weight", device).t()
            for e in range(cfg.num_local_experts)])

    shared = {}
    if src.has(pre + ".shared_expert.gate_proj.weight"):
        def lin(name, spec):
            return _linear_from_src(src, f"{pre}.shared_expert.{name}", spec,
                                    None, device)
        shared = dict(
            shared_gate=lin("gate_proj", specs.up),
            shared_up=lin("up_proj", specs.up),
            shared_down=lin("down_proj", specs.down),
            shared_route=_f32(src, pre + ".shared_expert_gate.weight",
                              device).t().contiguous().to(torch.bfloat16))
    return MoEParams(
        router=_f32(src, pre + ".gate.weight", device).t().contiguous().to(
            torch.bfloat16),
        gate=expert_from_float(stack(names[0]), specs.gate),
        up=expert_from_float(stack(names[1]), specs.up),
        down=expert_from_float(stack(names[2]), specs.down),
        **shared)


def params_from_source(
    src: TensorSource,
    cfg: ModelConfig,
    specs: DecoderSpecs,
    outlier_sets: Optional[Dict[str, Q.OutlierSet]] = None,
    device="cuda",
) -> DecoderParams:
    """Convert an HF state dict into DecoderParams on `device`, quantizing
    per `specs`, as JAX's params_from_source does for dense blocks:
    weights widened to f32 and transposed to [K, N], norm scales and
    biases in f32 (gemma's +1 offset folded in; qwen3's q_norm / k_norm as
    stored), phi3's and chatglm's packed [gate; up] split at I, gate first
    (JAX's mixq_tpu/models/hf.py:706-710), a plain MLP's gate None, embed,
    head and OPT's positions (their first two rows, HF's offset, dropped:
    :749-754) in bf16 (JAX's default store dtype), the head None when
    tied; an MoE block's MLP from `_moe_from_src`.

    outlier_sets: per-layer sets keyed "{i}.wqkv", "{i}.wo", "{i}.up"
    (shared by gate), "{i}.down", e.g. from quantize.calibration."""
    scheme = scheme_for(cfg.model_type)
    osets = outlier_sets or {}
    # gemma stores RMSNorm weights as w and applies (1 + w): fold the +1
    # into the stored scale so the runtime norm stays uniform
    norm_off = 1.0 if cfg.model_type in ("gemma", "gemma2") else 0.0

    def vec(key, i=None):
        """The first present of `key`'s names (a name or a tuple)."""
        for k in ((key,) if isinstance(key, str) else key or ()):
            name = k.format(i=i) if i is not None else k
            if src.has(name):
                return _f32(src, name, device)
        return None

    def norm_vec(key, i=None):
        v = vec(key, i)
        return None if v is None else v + norm_off

    def linear(slot, spec, oset, i):
        return _linear_from_src(src, scheme[slot].format(i=i), spec, oset,
                                device)

    def gate_up(i, oset):
        """(gate, up), sharing one outlier set: two tensors, or one
        packed [gate; up] split at I; (None, up) for a plain MLP."""
        if not scheme.get("gate") and not scheme.get("packed_gate_up"):
            return None, linear("up", specs.up, oset, i)
        if not scheme.get("packed_gate_up"):
            return (linear("gate", specs.gate, oset, i),
                    linear("up", specs.up, oset, i))
        w = _f32(src, scheme["up"].format(i=i) + ".weight", device)
        I = cfg.intermediate_size
        return (from_float(w[:I].t().contiguous(), specs.gate,
                           outlier_set=oset),
                from_float(w[I:].t().contiguous(), specs.up,
                           outlier_set=oset))

    blocks = []
    for i in range(cfg.num_hidden_layers):
        wq, wk, wv = _qkv_from_src(src, scheme, i, cfg, specs.wqkv,
                                   osets.get(f"{i}.wqkv"), device)
        if cfg.num_local_experts > 0:
            mlp = MLPParams(up=None, gate=None, down=None,
                            moe=_moe_from_src(src, cfg, specs, i, device))
        else:
            gate, up = gate_up(i, osets.get(f"{i}.up"))
            mlp = MLPParams(up=up, gate=gate,
                            down=linear("down", specs.down,
                                        osets.get(f"{i}.down"), i))
        blocks.append(BlockParams(
            ln1_scale=norm_vec(scheme["ln1"], i),
            ln1_bias=vec(scheme.get("ln1_bias"), i),
            attn=AttnParams(wq=wq, wk=wk, wv=wv,
                            wo=linear("o", specs.wo, osets.get(f"{i}.wo"),
                                      i),
                            q_norm=vec(scheme.get("q_norm"), i),
                            k_norm=vec(scheme.get("k_norm"), i)),
            ln2_scale=norm_vec(scheme.get("ln2"), i),
            ln2_bias=vec(scheme.get("ln2_bias"), i),
            mlp=mlp,
            post_attn_norm_scale=norm_vec(scheme.get("post_attn"), i),
            post_ffw_norm_scale=norm_vec(scheme.get("post_ffw"), i),
        ))

    embed = _f32(src, scheme["embed"], device).to(torch.bfloat16)
    lm_head = None
    if not cfg.tie_word_embeddings and src.has(scheme["lm_head"]):
        lm_head = _f32(src, scheme["lm_head"], device).t().contiguous().to(
            torch.bfloat16)
    pos_embed = None
    if scheme.get("pos_embed") and src.has(scheme["pos_embed"]):
        pe = _f32(src, scheme["pos_embed"], device)
        if cfg.model_type == "opt":
            pe = pe[2:]        # OPT's learned positions carry a +2 offset
        pos_embed = pe.to(torch.bfloat16)
    return DecoderParams(embed=embed, blocks=tuple(blocks),
                         lnf_scale=norm_vec(scheme["lnf"]),
                         lnf_bias=vec(scheme.get("lnf_bias")),
                         lm_head=lm_head, pos_embed=pos_embed)


def load_hf_config(path: str) -> ModelConfig:
    """The ModelConfig of an HF checkpoint directory's config.json."""
    with open(os.path.join(path, "config.json")) as f:
        return config_from_hf(json.load(f))


def load_model(
    path: str,
    specs: Optional[DecoderSpecs] = None,
    outlier_sets: Optional[Dict[str, Q.OutlierSet]] = None,
    device="cuda",
) -> Tuple[DecoderParams, ModelConfig]:
    """Load (and optionally quantize on the fly) an HF checkpoint directory
    onto `device`."""
    cfg = load_hf_config(path)
    specs = specs or DecoderSpecs.fp16()
    src = TensorSource.from_safetensors_dir(path, device)
    return params_from_source(src, cfg, specs, outlier_sets,
                              device=device), cfg
