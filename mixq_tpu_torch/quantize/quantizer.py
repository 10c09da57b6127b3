"""Offline quantization: policy resolution and model conversion
(mirrors mixq_tpu/quantize/quantizer.py).

    specs = resolve_specs(quant_cfg)      # QuantConfig -> DecoderSpecs
    qparams, specs = quantize_model(src, cfg, quant_cfg, calib_batches,
                                    device="cuda")

The reference policy tables: in 4-bit models the eightbit-only linears
(down_proj / o_proj / fc_out) stay W8A8, weight-only names (and a
WEIGHT_ONLY config) give W8A16 linears, and the gate linear fuses SiLU.
W8A8 MIX models start with empty, budget-reserved outlier sets that the
online predictor fills at warmup (quantize/online.py); 4-bit models take
the top-budget channels of calibration. QUIK raises NotImplementedError,
as the port's QUIK linears do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from mixq_tpu_torch.config import ModelConfig, QuantConfig
from mixq_tpu_torch.models.decoder import DecoderParams, DecoderSpecs
from mixq_tpu_torch.models.hf import TensorSource, params_from_source
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.mixed_linear import LinearSpec
from mixq_tpu_torch.quantize.calibration import (collect_act_scales,
                                                 outlier_sets_from_scales)

# per-architecture weight-only defaults (the reference's weight_only_map:
# empty for every family except GPT-J's fc_out)
ARCH_WEIGHT_ONLY = {"gptj": ("fc_out",)}

# the decoder's linear slots -> the reference's module names
SLOT_NAMES = {
    "wqkv": ("q_proj", "k_proj", "v_proj", "W_pack"),
    "wo": ("o_proj", "dense", "out_proj"),
    "up": ("up_proj", "fc_in", "dense_h_to_4h"),
    "gate": ("gate_proj",),
    "down": ("down_proj", "fc_out", "dense_4h_to_h"),
}


def apply_arch_policy(qcfg: QuantConfig, model_type: str) -> QuantConfig:
    """Fold the architecture's default weight-only table into a QuantConfig
    that doesn't override it."""
    arch = ARCH_WEIGHT_ONLY.get(model_type)
    if arch and not qcfg.weight_only_names:
        return dataclasses.replace(qcfg, weight_only_names=arch)
    return qcfg


def _spec_for(qcfg: QuantConfig, names) -> LinearSpec:
    if (qcfg.version == "WEIGHT_ONLY"
            or any(n in qcfg.weight_only_names for n in names)):
        return LinearSpec(w_bit=qcfg.w_bit, a_bit=16, version="WEIGHT_ONLY",
                          outlier_budget=qcfg.outlier_budget)
    w_bit, a_bit = qcfg.w_bit, qcfg.a_bit
    if qcfg.w_bit < 8 and any(n in qcfg.eightbit_only_names for n in names):
        w_bit, a_bit = 8, 8
    if qcfg.version == "FP16" or w_bit >= 16:
        return LinearSpec(version="FP16", w_bit=16)
    if qcfg.version == "QUIK" and qcfg.q_group_size > 0:
        raise ValueError(
            "QUIK does not support group quantization "
            f"(q_group_size={qcfg.q_group_size}); use q_group_size=0")
    return LinearSpec(
        w_bit=w_bit, a_bit=a_bit,
        version=qcfg.version if qcfg.version in ("MIX", "QUIK") else "MIX",
        outlier_budget=qcfg.outlier_budget, group_size=qcfg.q_group_size)


def resolve_specs(qcfg: QuantConfig) -> DecoderSpecs:
    """The per-linear precision policy of a QuantConfig."""
    base = {slot: _spec_for(qcfg, names) for slot, names in SLOT_NAMES.items()}
    base["gate"] = dataclasses.replace(base["gate"], fuse="silu")
    return DecoderSpecs(**base)


def quantize_model(
    src: TensorSource,
    cfg: ModelConfig,
    qcfg: QuantConfig,
    calib_batches: Optional[Iterable] = None,
    act_scales: Optional[Dict] = None,
    fp_params: Optional[DecoderParams] = None,
    device="cuda",
) -> tuple[DecoderParams, DecoderSpecs]:
    """Full offline quantization onto `device`.

    W8A8 MIX: outlier sets start empty, the whole budget reserved (the
    online predictor fills them during engine warmup). 4-bit: the sets are
    the top-budget channels of the calibration scales, from `act_scales`
    or from fp forwards over `calib_batches` (on `fp_params`, else on an
    FP16-spec copy of the weights built here and freed after)."""
    qcfg = apply_arch_policy(qcfg, cfg.model_type)
    if qcfg.version == "QUIK":
        raise NotImplementedError("quantize_model: QUIK is not ported")
    specs = resolve_specs(qcfg)
    osets: Optional[Dict[str, Q.OutlierSet]] = None
    if qcfg.w_bit <= 4:
        if act_scales is None:
            if calib_batches is None:
                raise ValueError(
                    "4-bit quantization needs calib_batches or act_scales")
            if fp_params is None:
                fp_params = params_from_source(src, cfg, DecoderSpecs.fp16(),
                                               device=device)
            act_scales = collect_act_scales(fp_params, cfg, calib_batches)
            del fp_params       # this reference to the FP16 copy goes first
        osets = outlier_sets_from_scales(act_scales, qcfg, device=device)
    elif qcfg.version == "MIX" and qcfg.w_bit == 8:
        # empty sets, the full budget reserved: the forward always runs the
        # outlier term at its static shape, and warmup fills the sets
        osets = empty_outlier_sets(cfg, qcfg, device=device)
    return params_from_source(src, cfg, specs, osets, device=device), specs


def empty_outlier_sets(cfg: ModelConfig, qcfg: QuantConfig,
                       device="cuda") -> Dict[str, Q.OutlierSet]:
    """Budget-reserved empty outlier sets for every linear group."""
    H = cfg.hidden_size
    k_of = {"wqkv": H, "wo": cfg.num_attention_heads * cfg.head_dim_,
            "up": H, "down": cfg.intermediate_size}
    return {f"{i}.{slot}": Q.empty_outlier_set(k, qcfg.outlier_budget,
                                               device=device)
            for i in range(cfg.num_hidden_layers)
            for slot, k in k_of.items()}
