"""Online outlier predictor: warmup-time detection and weight promotion
(mirrors mixq_tpu/quantize/online.py).

During the first `max_steps` (= 2) forwards, every activation channel whose
|x| exceeds sigma (= 6) joins a sticky per-linear outlier set; its weight
rows are promoted to bf16 (`w_outlier`) and zeroed in the int weight; then
the set freezes. The steady-state forward always runs the budget-padded
outlier term, so promotion changes parameter values, never shapes: a
warmed model serves through the same kernels and the same graph as before.

An MoE block's MLP takes no outlier set (its experts quantize per (expert,
slot) row, as JAX's): its None up, gate and down are passed over when
promoting and counting, and `_replace` keeps its `moe` leaf.

Each warmup batch runs the stats forward (forward(collect_stats=True)) on a
fresh batch-major bf16 cache of its own length, on the parameters' device;
the detector and the promotion run there too. Deciding whether a linear
changed reads its count on the host, once per linear and step: warmup is
off the hot path.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.models.decoder import DecoderParams, DecoderSpecs
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                             promote_outliers)
from mixq_tpu_torch.quantize.calibration import stats_forward

# the linears of a block, by the stats slot of their input
SLOT_LINEARS = (("wqkv", "attn", ("wq", "wk", "wv")), ("wo", "attn", ("wo",)),
                ("up", "mlp", ("up", "gate")), ("down", "mlp", ("down",)))


def warmup_online_outliers(
    params: DecoderParams,
    cfg: ModelConfig,
    specs: DecoderSpecs,
    batches: Iterable,                  # warmup token batches [B, T]
    sigma: float = 6.0,
    max_steps: int = 2,
    head_f32: Optional[torch.Tensor] = None,
    stats_log: Optional[List[Dict[str, torch.Tensor]]] = None,
) -> Tuple[DecoderParams, Dict[str, int]]:
    """Run up to `max_steps` warmup forwards, detecting and promoting
    outlier channels after each. Returns (the updated params, {"{layer}.
    {wqkv|wo|up|down}": outlier count}). `head_f32` is the caller's widened
    head (the engine's), made here when absent; a `stats_log` list gets
    each step's statistics."""
    if params.stacked is not None:
        raise NotImplementedError("stacked (scan) params are not ported")
    for step, batch in enumerate(batches):
        if step >= max_steps:
            break
        stats = stats_forward(params, cfg, specs, batch, head_f32)
        if stats_log is not None:
            stats_log.append(stats)
        params = _promote_from_stats(params, specs, stats, sigma)
    counts: Dict[str, int] = {}
    for i, bp in enumerate(params.blocks):
        for slot, part, names in SLOT_LINEARS:
            lin = getattr(getattr(bp, part), names[0])
            if lin is not None and lin.out_count is not None:
                counts[f"{i}.{slot}"] = int(lin.out_count)
    return params, counts


def _promote_linear(lin: Optional[MixLinearParams], spec: LinearSpec,
                    ch_max: torch.Tensor,
                    sigma: float) -> Optional[MixLinearParams]:
    if lin is None or lin.out_ind is None or spec.version != "MIX":
        return lin
    oset = lin.outlier_set
    new_oset = Q.detect_new_outliers_from_absmax(ch_max, oset, sigma)
    if int(new_oset.count) == int(oset.count):
        return lin
    return promote_outliers(lin, None, new_oset, spec)


def _promote_from_stats(params: DecoderParams, specs: DecoderSpecs,
                        stats: Dict[str, torch.Tensor],
                        sigma: float) -> DecoderParams:
    spec_of = {"wq": specs.wqkv, "wk": specs.wqkv, "wv": specs.wqkv,
               "wo": specs.wo, "up": specs.up, "gate": specs.gate,
               "down": specs.down}
    blocks = []
    for i, bp in enumerate(params.blocks):
        parts = {"attn": {}, "mlp": {}}
        for slot, part, names in SLOT_LINEARS:
            for name in names:
                parts[part][name] = _promote_linear(
                    getattr(getattr(bp, part), name), spec_of[name],
                    stats[f"{i}.{slot}"], sigma)
        # _replace keeps every other field (the norms, gemma2's post-norms)
        blocks.append(bp._replace(attn=bp.attn._replace(**parts["attn"]),
                                  mlp=bp.mlp._replace(**parts["mlp"])))
    return params._replace(blocks=tuple(blocks))
