"""HuggingFace weights into the port's DecoderParams (mirrors
mixq_tpu/models/hf.py).

    cfg = config_from_hf(hf_config_dict)
    src = TensorSource.from_torch_state_dict(model.state_dict())
    params = params_from_source(src, cfg, specs, outlier_sets, device=...)

    params, cfg = load_model(hf_dir, specs, device="cuda")

Ported: `TensorSource` over a dict, a torch state dict or an HF
safetensors directory (read by the port's own utils/safetensors_io.py),
`config_from_hf`, `load_hf_config`, `load_model`, and the weight-name
schemes for the llama, baichuan, mistral and gemma2 families, and
`params_from_source` for their dense blocks (separate q/k/v, or
baichuan's fused `W_pack` split at load, gated MLP, gemma's +1 norm
offset, gemma2's post-norms, a tied head). Every weight is quantized where
its tensor lies or on `device`: a state dict on the card is quantized on
the card, one tensor at a time, never through numpy; a tensor goes to
`device` in its stored dtype and is widened there. The other families,
falcon's interleaved query_key_value, MoE blocks and rope scaling are
still to be ported (ROADMAP.md Queue A); they raise.
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
from mixq_tpu_torch.utils.safetensors_io import SafeTensorsFile

PORTED_FAMILIES = ("llama", "baichuan", "mistral", "gemma2")


# ---------------------------------------------------------------------------
# Config mapping
# ---------------------------------------------------------------------------

def _check_rope_scaling(hf: Dict) -> None:
    """JAX maps "linear" and "llama3" rope scaling and raises on any other
    type; the port's RoPE is unscaled, so every scaled rope raises."""
    rs = hf.get("rope_scaling") or None
    if not rs:
        return
    rtype = rs.get("rope_type", rs.get("type", "default"))
    if rtype == "default":
        return
    if rtype in ("linear", "llama3"):
        raise NotImplementedError(
            f"rope_scaling type {rtype!r} is not ported (unscaled rope only)")
    raise ValueError(f"unsupported rope_scaling type {rtype!r}")


def config_from_hf(hf: Dict) -> ModelConfig:
    """Map an HF config dict to ModelConfig, field for field as JAX's
    config_from_hf does, for the llama, baichuan, mistral and gemma2
    families."""
    mt = hf.get("model_type", "llama")
    if mt not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"config_from_hf: model_type {mt!r} is not ported "
            f"({', '.join(PORTED_FAMILIES)} only)")
    _check_rope_scaling(hf)
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
        intermediate_size=hf["intermediate_size"],
    )
    n_kv = hf.get("num_key_value_heads", common["num_attention_heads"])
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
        )
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
        attention_bias=hf.get("attention_bias", False),
        sliding_window=(hf.get("sliding_window")
                        if hf.get("use_sliding_window", mt == "mistral")
                        else None),
        alibi=alibi,
        rope_style="none" if alibi else "neox",
    )


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
    "mistral": _LLAMA,
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


def scheme_for(model_type: str) -> Dict[str, Optional[str]]:
    if model_type not in _SCHEMES:
        raise NotImplementedError(
            f"no weight scheme for model_type {model_type!r} in the port "
            f"({', '.join(PORTED_FAMILIES)} only)")
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
    activation): from separate q/k/v tensors, or from a fused [q | k | v]
    tensor (baichuan's W_pack) split by rows at n_q*hd and n_q*hd +
    n_kv*hd, its bias too (JAX's _qkv_from_src, mixq_tpu/models/hf.py:
    550-609, its non-falcon branch)."""
    if not scheme.get("qkv"):
        return tuple(_linear_from_src(src, scheme[n].format(i=i), spec,
                                      oset, device) for n in ("q", "k", "v"))
    prefix = scheme["qkv"].format(i=i)
    w = _f32(src, prefix + ".weight", device)
    bias = (_f32(src, prefix + ".bias", device)
            if src.has(prefix + ".bias") else None)
    hd = cfg.head_dim_
    sizes = [cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd,
             cfg.num_key_value_heads * hd]
    ws = torch.split(w, sizes, dim=0)
    bs = torch.split(bias, sizes, dim=0) if bias is not None else (None,) * 3
    return tuple(from_float(wp.t().contiguous(), spec, bias=bp,
                            outlier_set=oset) for wp, bp in zip(ws, bs))


def params_from_source(
    src: TensorSource,
    cfg: ModelConfig,
    specs: DecoderSpecs,
    outlier_sets: Optional[Dict[str, Q.OutlierSet]] = None,
    device="cuda",
) -> DecoderParams:
    """Convert an HF state dict into DecoderParams on `device`, quantizing
    per `specs`, as JAX's params_from_source does for dense blocks:
    weights widened to f32 and transposed to [K, N], norm scales in f32
    (gemma's +1 offset folded in), embed and head in bf16 (JAX's default
    store dtype), the head None when tied.

    outlier_sets: per-layer sets keyed "{i}.wqkv", "{i}.wo", "{i}.up"
    (shared by gate), "{i}.down", e.g. from quantize.calibration."""
    scheme = scheme_for(cfg.model_type)
    if cfg.num_local_experts > 0:
        raise NotImplementedError("MoE blocks are not ported")
    osets = outlier_sets or {}
    # gemma stores RMSNorm weights as w and applies (1 + w): fold the +1
    # into the stored scale so the runtime norm stays uniform
    norm_off = 1.0 if cfg.model_type in ("gemma", "gemma2") else 0.0

    def norm_vec(key, i=None):
        if not key:
            return None
        name = key.format(i=i) if i is not None else key
        if not src.has(name):
            return None
        return _f32(src, name, device) + norm_off

    def linear(slot, spec, oset, i):
        return _linear_from_src(src, scheme[slot].format(i=i), spec, oset,
                                device)

    blocks = []
    for i in range(cfg.num_hidden_layers):
        wq, wk, wv = _qkv_from_src(src, scheme, i, cfg, specs.wqkv,
                                   osets.get(f"{i}.wqkv"), device)
        up_oset = osets.get(f"{i}.up")
        blocks.append(BlockParams(
            ln1_scale=norm_vec(scheme["ln1"], i),
            ln1_bias=None,
            attn=AttnParams(wq=wq, wk=wk, wv=wv,
                            wo=linear("o", specs.wo, osets.get(f"{i}.wo"),
                                      i)),
            ln2_scale=norm_vec(scheme.get("ln2"), i),
            ln2_bias=None,
            mlp=MLPParams(up=linear("up", specs.up, up_oset, i),
                          gate=linear("gate", specs.gate, up_oset, i),
                          down=linear("down", specs.down,
                                      osets.get(f"{i}.down"), i)),
            post_attn_norm_scale=norm_vec(scheme.get("post_attn"), i),
            post_ffw_norm_scale=norm_vec(scheme.get("post_ffw"), i),
        ))

    embed = _f32(src, scheme["embed"], device).to(torch.bfloat16)
    lm_head = None
    if not cfg.tie_word_embeddings and src.has(scheme["lm_head"]):
        lm_head = _f32(src, scheme["lm_head"], device).t().contiguous().to(
            torch.bfloat16)
    return DecoderParams(embed=embed, blocks=tuple(blocks),
                         lnf_scale=norm_vec(scheme["lnf"]), lnf_bias=None,
                         lm_head=lm_head)


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
