"""Per-linear precision policy (mirrors mixq_tpu/quantize/quantizer.py:
`ARCH_WEIGHT_ONLY`, `apply_arch_policy`, `resolve_specs`).

    specs = resolve_specs(quant_cfg)      # QuantConfig -> DecoderSpecs

The reference policy tables: in 4-bit models the eightbit-only linears
(down_proj / o_proj / fc_out) stay W8A8, weight-only names (and a
WEIGHT_ONLY config) give W8A16 linears, and the gate linear fuses SiLU.
"""
from __future__ import annotations

import dataclasses

from mixq_tpu_torch.config import QuantConfig
from mixq_tpu_torch.models.decoder import DecoderSpecs
from mixq_tpu_torch.ops.mixed_linear import LinearSpec

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
