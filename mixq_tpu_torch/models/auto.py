"""AutoModel: one-call loading of fp16 / quantized checkpoints onto a
device (mirrors mixq_tpu/models/auto.py).

    params, cfg, specs = AutoModel.from_pretrained(hf_dir, QuantConfig.w8a8())
    params, cfg, specs = AutoModel.from_quantized(ckpt_dir)
    engine = AutoModel.engine(path, EngineConfig(...))

Each entry point runs on the card unless the caller passes device="cpu".
A directory with a `manifest.json` is a quantized checkpoint
(quantize/checkpoint.py); any other is an HF safetensors directory
(models/hf.py::TensorSource.from_safetensors_dir). Only the families the
port serves load; the others are ROADMAP Queue A item 6.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

from mixq_tpu_torch.config import EngineConfig, ModelConfig, QuantConfig
from mixq_tpu_torch.models.decoder import DecoderParams, DecoderSpecs
from mixq_tpu_torch.models.hf import (PORTED_FAMILIES, TensorSource,
                                      config_from_hf, params_from_source)
from mixq_tpu_torch.quantize.checkpoint import load_checkpoint
from mixq_tpu_torch.quantize.quantizer import quantize_model, resolve_specs

SUPPORTED_MODEL_TYPES = PORTED_FAMILIES

Loaded = Tuple[DecoderParams, ModelConfig, DecoderSpecs]


def _hf_config(path: str) -> ModelConfig:
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    mt = hf.get("model_type", "llama")
    if mt not in SUPPORTED_MODEL_TYPES:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported (have: "
            f"{', '.join(SUPPORTED_MODEL_TYPES)}; the other families are "
            "ROADMAP Queue A item 6)")
    return config_from_hf(hf)


def _load(path: str, device, kwargs) -> Loaded:
    if os.path.exists(os.path.join(path, "manifest.json")):
        return AutoModel.from_quantized(path, device=device)
    return AutoModel.from_pretrained(path, device=device, **kwargs)


class AutoModel:
    """Entry points mirroring the reference's AutoForCausalLM."""

    @staticmethod
    def from_pretrained(
        path: str,
        quant_config: Optional[QuantConfig] = None,
        calib_batches: Optional[Iterable] = None,
        act_scales: Optional[Dict] = None,
        device="cuda",
    ) -> Loaded:
        """Load an HF checkpoint directory onto `device`; quantize on the
        fly when quant_config is given (4-bit from calib_batches or
        act_scales)."""
        cfg = _hf_config(path)
        src = TensorSource.from_safetensors_dir(path, device)
        if quant_config is None:
            specs = DecoderSpecs.fp16()
            return (params_from_source(src, cfg, specs, device=device), cfg,
                    specs)
        params, specs = quantize_model(
            src, cfg, quant_config, calib_batches=calib_batches,
            act_scales=act_scales, device=device)
        return params, cfg, specs

    @staticmethod
    def from_quantized(path: str, device="cuda") -> Loaded:
        """Load a quantized checkpoint (the port's or JAX's) onto
        `device`."""
        params, cfg, qcfg = load_checkpoint(path, device=device)
        return params, cfg, resolve_specs(qcfg)

    @staticmethod
    def engine(path: str, engine_config: Optional[EngineConfig] = None,
               device="cuda", **kwargs):
        """An InferenceEngine straight from a checkpoint directory."""
        from mixq_tpu_torch.engine import InferenceEngine

        params, cfg, specs = _load(path, device, kwargs)
        return InferenceEngine(params, cfg, specs, engine_config,
                               device=device)

    @staticmethod
    def serving_engine(path: str, engine_config: Optional[EngineConfig] = None,
                       mesh=None, device="cuda", **kwargs):
        """A ContinuousBatchingEngine (slot-pool serving with per-request
        sampling) straight from a checkpoint directory."""
        from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

        params, cfg, specs = _load(path, device, kwargs)
        return ContinuousBatchingEngine(params, cfg, specs, engine_config,
                                        mesh=mesh, device=device)
