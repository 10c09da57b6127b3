"""Quantization (mirrors mixq_tpu/quantize/): the per-linear policy,
calibration, `quantize_model`, the online outlier predictor's warmup, and
checkpoints in JAX's on-disk layout (`save_checkpoint` /
`load_checkpoint`)."""
from mixq_tpu_torch.quantize.calibration import (
    collect_act_scales,
    load_act_scales,
    outlier_sets_from_scales,
    save_act_scales,
    sigma_outlier_sets_from_scales,
)
from mixq_tpu_torch.quantize.checkpoint import (load_checkpoint,
                                                save_checkpoint)
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
    "load_checkpoint",
    "outlier_sets_from_scales",
    "quantize_model",
    "resolve_specs",
    "save_act_scales",
    "save_checkpoint",
    "sigma_outlier_sets_from_scales",
    "warmup_online_outliers",
]
