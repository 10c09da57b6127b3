"""Quantization (mirrors mixq_tpu/quantize/): the per-linear policy,
calibration, `quantize_model` and the online outlier predictor's warmup.
Checkpoints are still to be ported (ROADMAP.md Queue A)."""
from mixq_tpu_torch.quantize.calibration import (
    collect_act_scales,
    load_act_scales,
    outlier_sets_from_scales,
    save_act_scales,
    sigma_outlier_sets_from_scales,
)
from mixq_tpu_torch.quantize.online import warmup_online_outliers
from mixq_tpu_torch.quantize.quantizer import (
    apply_arch_policy,
    empty_outlier_sets,
    quantize_model,
    resolve_specs,
)

__all__ = [
    "apply_arch_policy",
    "collect_act_scales",
    "empty_outlier_sets",
    "load_act_scales",
    "outlier_sets_from_scales",
    "quantize_model",
    "resolve_specs",
    "save_act_scales",
    "sigma_outlier_sets_from_scales",
    "warmup_online_outliers",
]
