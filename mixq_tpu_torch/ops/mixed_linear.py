"""Mixed-precision linear layers (mirrors mixq_tpu/ops/mixed_linear.py).

A quantized linear is a plain tensor container plus a static spec:

    y = mixed_linear(params: MixLinearParams, x, spec: LinearSpec)

Every int8-activation linear (MIX: W8 or packed W4, per-channel [N] or
grouped [G, N] scales) runs its GEMM with the dequant/outlier/SiLU epilogue
on the card through kernels/mix_gemm.py (kernel 2 / kernel A); a QUIK
linear (`quik_linear`: static outlier set, asymmetric activations) runs on
the same kernels in their zero-point modes; a WEIGHT_ONLY (W8A16) linear
runs on the a16 kernel (kernels/w8a16.py, kernel B). The activation
preparation (outlier extract, inlier mask, per-token quantization) is
PyTorch glue, as it is jnp glue in JAX.

Int4 weights are stored packed, two per uint8 in the halves layout
(ops/quant.py::pack_int4): the port has no jnp.int4 storage and no storage
switches. `promote_outliers` is the online predictor's weight update
(warmup only).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from mixq_tpu_torch.kernels._build import apply_epilogue
from mixq_tpu_torch.kernels.mix_gemm import mix_gemm
from mixq_tpu_torch.kernels.w8a16 import mix_gemm_a16
from mixq_tpu_torch.ops import quant as Q

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
# the profiler range of quik_linear's activation glue (outlier extract,
# inlier mask, asymmetric quantization), which a profile of the QUIK
# decode step reads as its own share
QUIK_QUANT = "quik_act_quant"


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """Static per-layer precision policy."""

    w_bit: int = 8              # 4 | 8 | 16
    a_bit: int = 8              # 4 | 8 | 16
    version: str = "MIX"        # "MIX" | "QUIK" | "WEIGHT_ONLY" | "FP16"
    outlier_budget: int = 128
    fuse: str = "none"          # "none" | "silu" | "gelu" | "gelu_new"
    out_dtype: str = "bfloat16"
    group_size: int = -1        # >0: per-(K-group, out-channel) weight scales

    @property
    def odtype(self) -> torch.dtype:
        return _DTYPES[self.out_dtype]


class MixLinearParams(NamedTuple):
    """Quantized linear parameters; weight layout [K, N] (in-dim first).

    q_weight:  int8 [K, N]  (w_bit 8)  |  uint8 [K/2, N] (w_bit 4, packed)
               |  [K, N] fp (FP16 spec)
    w_scale:   f32 [N]      per-out-channel scale | f32 [G, N] per group
    w_outlier: bf16 [B, N] | None   fp weight rows of the outlier channels
    out_ind:   int32 [B]   | None   outlier channel indices (padded)
    out_mask:  f32 [B]     | None   1 for live outlier slots
    k_mask:    f32 [K]     | None   1 for inlier channels
    out_count: int32 []    | None
    bias:      [N]         | None
    reduced_w: f32 [N]     | None   QUIK's zero-point term: the column
                                    sums of the int weight values
    """

    q_weight: torch.Tensor
    w_scale: torch.Tensor
    w_outlier: Optional[torch.Tensor] = None
    out_ind: Optional[torch.Tensor] = None
    out_mask: Optional[torch.Tensor] = None
    k_mask: Optional[torch.Tensor] = None
    out_count: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    reduced_w: Optional[torch.Tensor] = None

    @property
    def outlier_set(self) -> Optional[Q.OutlierSet]:
        if self.out_ind is None:
            return None
        return Q.OutlierSet(self.out_ind, self.out_mask, self.k_mask,
                            self.out_count)


class QuantizedAct(NamedTuple):
    """A pre-quantized activation shared by every linear that reads the
    same input (the reference's MixLibCache q_xcache / x_scale /
    activation_outliers)."""

    q_x: torch.Tensor                     # int8 [..., K], outliers zeroed
    x_scale: torch.Tensor                 # f32 [..., 1]
    x_outlier: Optional[torch.Tensor]     # [..., B] fp outlier activations


def int_weight(params: MixLinearParams, spec: LinearSpec) -> torch.Tensor:
    """The int8 [K, N] weight values (packed int4 storage unpacked)."""
    qw = params.q_weight
    if spec.w_bit == 4 and qw.dtype == torch.uint8:
        return Q.unpack_int4(qw)
    return qw


def _apply_fuse(y: torch.Tensor, fuse: str, out_dtype) -> torch.Tensor:
    """The GEMM kernels' epilogue, in f32, outside a kernel (FP16 linears,
    linears with a bias)."""
    return apply_epilogue(y.float(), fuse).to(out_dtype)


def prepare_act(x: torch.Tensor, params: MixLinearParams,
                spec: LinearSpec) -> QuantizedAct:
    """Quantize an fp activation for a mixed linear: extract the outlier
    channels, zero them, per-token scale and cast."""
    oset = params.outlier_set
    if oset is not None:
        x_out = Q.extract_outliers(x, oset)
        x_in = Q.mask_inliers(x, oset)
    else:
        x_out, x_in = None, x
    q_x, x_scale = Q.quantize_act_per_token(x_in, bits=min(spec.a_bit, 8))
    return QuantizedAct(q_x, x_scale, x_out)


def mixed_linear_prepared(params: MixLinearParams, act: QuantizedAct,
                          spec: LinearSpec) -> torch.Tensor:
    """Mixed int GEMM on a pre-quantized activation (the reference's
    forward_without_precondition[FusedSilu]): W8 or packed W4, per-channel
    or grouped scales, all on the mix_gemm wrapper."""
    lead = act.q_x.shape[:-1]
    K = act.q_x.shape[-1]
    x_out = None
    if act.x_outlier is not None and params.w_outlier is not None:
        x_out = act.x_outlier.reshape(-1, act.x_outlier.shape[-1])
    if params.bias is None:
        y = mix_gemm(act.q_x.reshape(-1, K), params.q_weight,
                     act.x_scale.reshape(-1, 1), params.w_scale, x_out,
                     params.w_outlier, fuse=spec.fuse, out_dtype=spec.odtype)
    else:
        y = mix_gemm(act.q_x.reshape(-1, K), params.q_weight,
                     act.x_scale.reshape(-1, 1), params.w_scale, x_out,
                     params.w_outlier, out_dtype=torch.float32)
        y = _apply_fuse(y + params.bias.float(), spec.fuse, spec.odtype)
    return y.reshape(*lead, params.q_weight.shape[1])


def mixed_linear(params: MixLinearParams, x: torch.Tensor,
                 spec: LinearSpec) -> torch.Tensor:
    """Full mixed-precision linear on an fp activation."""
    if spec.version == "FP16" or spec.w_bit == 16:
        # plain matmul, as JAX leaves it to XLA: f32 accumulation
        y = torch.matmul(x.float(), params.q_weight.to(x.dtype).float())
        if params.bias is not None:
            y = y + params.bias.float()
        return _apply_fuse(y, spec.fuse, spec.odtype)
    if spec.version == "WEIGHT_ONLY":
        return w8a16_linear(params, x, spec)
    if spec.version == "QUIK":
        return quik_linear(params, x, spec)
    return mixed_linear_prepared(params, prepare_act(x, params, spec), spec)


def w8a16_linear(params: MixLinearParams, x: torch.Tensor,
                 spec: LinearSpec) -> torch.Tensor:
    """Weight-only linear (EETQ.w8_a16_gemm): the weight stays int8 (or
    packed int4) in device memory and is dequantized to bf16 inside the
    a16 kernel, `wd = bf16(w) * bf16(w_scale)`, then a bf16 x bf16 -> f32
    GEMM. JAX computes the same function in jnp for an int8 per-channel
    weight; the kernel also takes packed int4 and grouped scales."""
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16).contiguous()
    if params.bias is None:
        y = mix_gemm_a16(x2, params.q_weight, params.w_scale, fuse=spec.fuse,
                         out_dtype=spec.odtype)
    else:
        y = mix_gemm_a16(x2, params.q_weight, params.w_scale,
                         out_dtype=torch.float32)
        y = _apply_fuse(y + params.bias.float(), spec.fuse, spec.odtype)
    return y.reshape(*lead, params.q_weight.shape[1])


def quik_linear(params: MixLinearParams, x: torch.Tensor,
                spec: LinearSpec) -> torch.Tensor:
    """QUIK's static-split linear (mirrors mixq_tpu/ops/mixed_linear.py::
    quik_linear): the calibrated outlier channels extracted and masked,
    asymmetric per-row quantization of the inliers, then the GEMM with the
    zero-point term x_scale * w_scale * (acc + x_zero * reduced_w), the
    outlier term and the epilogue on the mix_gemm wrapper (kernels 2 and A
    in their zero-point modes). A bias is added to the f32 result and the
    epilogue applied outside, as mixed_linear_prepared does."""
    oset = params.outlier_set
    with torch.profiler.record_function(QUIK_QUANT):
        if oset is not None:
            x_out = Q.extract_outliers(x, oset)
            x_in = Q.mask_inliers(x, oset)
        else:
            x_out, x_in = None, x
        q_x, x_scale, x_zero = Q.quantize_act_asymmetric(
            x_in, bits=min(spec.a_bit, 8))
    lead, K = q_x.shape[:-1], q_x.shape[-1]
    if x_out is not None and params.w_outlier is not None:
        x_out = x_out.reshape(-1, x_out.shape[-1])
    else:
        x_out = None
    args = (q_x.reshape(-1, K), params.q_weight, x_scale.reshape(-1, 1),
            params.w_scale, x_out, params.w_outlier)
    zp = dict(x_zero=x_zero.reshape(-1, 1), reduced_w=params.reduced_w)
    if params.bias is None:
        y = mix_gemm(*args, fuse=spec.fuse, out_dtype=spec.odtype, **zp)
    else:
        y = mix_gemm(*args, out_dtype=torch.float32, **zp)
        y = _apply_fuse(y + params.bias.float(), spec.fuse, spec.odtype)
    return y.reshape(*lead, params.q_weight.shape[1])


def from_float(
    w: torch.Tensor,
    spec: LinearSpec,
    bias: Optional[torch.Tensor] = None,
    outlier_set: Optional[Q.OutlierSet] = None,
    store_dtype: torch.dtype = torch.bfloat16,
) -> MixLinearParams:
    """Quantize an fp weight [K, N] into MixLinearParams. Outlier channels
    keep an fp copy in w_outlier and their int rows are zeroed (not for
    WEIGHT_ONLY linears, which take no outlier set, as in JAX). int4
    weights are packed (halves layout); group_size > 0 gives [G, N]
    scales. A QUIK linear also gets reduced_w, the column sums of its
    unpacked int weight values."""
    K, N = w.shape
    b = None if bias is None else bias.to(store_dtype)
    if spec.version == "FP16" or spec.w_bit == 16:
        return MixLinearParams(
            q_weight=w.to(store_dtype),
            w_scale=torch.ones((N,), dtype=torch.float32, device=w.device),
            bias=b)
    w_outlier = None
    oset_fields = (None, None, None, None)
    w_for_quant = w
    if outlier_set is not None and spec.version != "WEIGHT_ONLY":
        w_outlier = Q.gather_outlier_weights(w, outlier_set).to(store_dtype)
        w_for_quant = w * outlier_set.k_mask[:, None].to(w.dtype)
        oset_fields = tuple(outlier_set)
    if spec.group_size > 0 and spec.w_bit <= 8:
        q_w, w_scale = Q.quantize_weight_grouped(
            w_for_quant, bits=spec.w_bit, group_size=spec.group_size)
        if spec.w_bit == 4:
            q_w = Q.pack_int4(q_w)
    elif spec.w_bit == 8:
        q_w, w_scale = Q.quantize_weight_int8(w_for_quant)
    elif spec.w_bit == 4:
        q_w, w_scale = Q.quantize_weight_int4(w_for_quant)
        q_w = Q.pack_int4(q_w)
    else:
        raise ValueError(f"unsupported w_bit {spec.w_bit}")
    reduced_w = None
    if spec.version == "QUIK":
        # the sums of the int VALUES: packed storage is unpacked first
        reduced_w = Q.reduced_weight_rowsum(
            Q.unpack_int4(q_w) if q_w.dtype == torch.uint8 else q_w)
    return MixLinearParams(
        q_weight=q_w, w_scale=w_scale, w_outlier=w_outlier,
        out_ind=oset_fields[0], out_mask=oset_fields[1],
        k_mask=oset_fields[2], out_count=oset_fields[3], bias=b,
        reduced_w=reduced_w)


def promote_outliers(
    params: MixLinearParams,
    w_fp: Optional[torch.Tensor],
    new_oset: Q.OutlierSet,
    spec: LinearSpec,
) -> MixLinearParams:
    """Online outlier promotion (mirrors mixq_tpu/ops/mixed_linear.py::
    promote_outliers): with an updated outlier set, rebuild w_outlier and
    zero the set's rows in the int weight (packed W4 is unpacked, zeroed
    and repacked; w_scale is kept). Runs during warmup, off the steady-state
    forward.

    w_outlier comes from the fp weight `w_fp` [K, N] when given, else from
    the dequantized int weight, bf16(q_w * w_scale), as the reference's
    `q_weight[:, ind] * scale_col`. In that case a slot that was live
    before and holds the same channel keeps its w_outlier row: its int row
    was zeroed when it was promoted, so dequantizing it again would give
    zeros. (JAX regathers every slot from the zeroed weight there, and so
    loses the rows promoted by an earlier warmup step; ROADMAP.md Queue C.)
    Per-channel scales only without `w_fp`: JAX's w_scale[None, :] does not
    broadcast a grouped [G, N] scale against [K, N] and raises, so this
    raises too."""
    keep = None
    if w_fp is None:
        if params.w_scale.dim() != 1:
            raise ValueError(
                "promote_outliers: grouped [G, N] weight scales need the fp "
                "weight (w_fp); the int weight is dequantized with "
                "per-channel [N] scales only, as in JAX")
        w_fp = int_weight(params, spec).float() * params.w_scale[None, :]
        if params.w_outlier is not None and params.out_ind is not None:
            keep = ((params.out_mask > 0.5)
                    & (params.out_ind == new_oset.ind))[:, None]
    w_outlier = Q.gather_outlier_weights(w_fp, new_oset).to(torch.bfloat16)
    if keep is not None:
        w_outlier = torch.where(keep, params.w_outlier.to(torch.bfloat16),
                                w_outlier)
    q_w = (int_weight(params, spec).float()
           * new_oset.k_mask[:, None]).to(torch.int8)
    if spec.w_bit == 4 and params.q_weight.dtype == torch.uint8:
        q_w = Q.pack_int4(q_w)
    return params._replace(
        q_weight=q_w, w_outlier=w_outlier, out_ind=new_oset.ind,
        out_mask=new_oset.mask, k_mask=new_oset.k_mask,
        out_count=new_oset.count)
