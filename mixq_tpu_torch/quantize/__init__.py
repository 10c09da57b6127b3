"""Quantization policy (mirrors mixq_tpu/quantize/). Ported: the
per-linear policy resolution; calibration, `quantize_model` and checkpoints
are still to be ported (ROADMAP.md Queue A item 9)."""
from mixq_tpu_torch.quantize.quantizer import apply_arch_policy, resolve_specs

__all__ = ["apply_arch_policy", "resolve_specs"]
