"""Core quantization primitives in PyTorch (mirrors mixq_tpu/ops/quant.py).

Every function repeats the JAX arithmetic in the same order and dtypes, so
the integer results are bit-equal: `torch.round` and `jnp.round` both round
half to even, and each division is an IEEE f32 division on both sides.

Ported here: int8, int4 and group-wise weight quantization, int4 packing in
the halves layout, per-token activation and per-(token, head) KV
quantization, the static-budget outlier set and its helpers, the dequant
epilogue and the grouped int8 GEMM reference. Asymmetric (QUIK) quantization
and the online outlier detector are still to be ported (ROADMAP.md Queue A
item 2).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mixq_tpu_torch.utils.arith import true_div


# ---------------------------------------------------------------------------
# Weight quantization (offline, per output channel)
# ---------------------------------------------------------------------------

def quantize_weight_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 weight quant.

    w: [K, N] (in-dim, out-dim). Returns (q_w int8 [K, N], scale f32 [N])
    with scale = max|w|/127."""
    w = w.float()
    scale = torch.clamp_min(true_div(w.abs().amax(dim=0), 127.0), 1e-8)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight_int4(
    w: torch.Tensor, clip_scale_denom: float = 7.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int4 weight quant (unpacked, int8 storage):
    scale = max|w| / clip_scale_denom, values clamped to [-8, 7].
    Returns (q_w int8 [K, N], scale f32 [N])."""
    w = w.float()
    scale = torch.clamp_min(
        true_div(w.abs().amax(dim=0), clip_scale_denom), 1e-8)
    q = torch.clamp(torch.round(w / scale[None, :]), -8, 7).to(torch.int8)
    return q, scale


def quantize_weight_grouped(
    w: torch.Tensor, bits: int = 4, group_size: int = 128
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric weight quant: one scale per (K-group,
    out-channel). w: [K, N] -> (q int8 [K, N], scale f32 [K/group_size, N]);
    values clamp to [-qmax - 1, qmax]."""
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group {group_size}")
    qmax = 127.0 if bits == 8 else 7.0
    wg = w.float().reshape(K // group_size, group_size, N)
    scale = torch.clamp_min(true_div(wg.abs().amax(dim=1), qmax),
                            1e-8)                              # [G, N]
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax - 1, qmax)
    return q.reshape(K, N).to(torch.int8), scale


def grouped_int8_matmul_dequant(
    q_x: torch.Tensor,          # int8 [M, K]
    x_scale: torch.Tensor,      # f32 [M, 1]
    q_w: torch.Tensor,          # int8 [K, N]
    w_scale_g: torch.Tensor,    # f32 [G, N]
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Int8 GEMM with per-group weight scales: one exact integer product per
    K-group (in float64, exact for |acc| < 2**53), each rounded to f32 and
    scaled by its group's scales, summed over groups in f32, then times the
    row scale."""
    M, K = q_x.shape
    G, N = w_scale_g.shape
    xg = q_x.double().reshape(M, G, K // G)
    wg = q_w.double().reshape(G, K // G, N)
    acc = torch.einsum("mgk,gkn->gmn", xg, wg).float()           # [G, M, N]
    y = torch.sum(acc * w_scale_g[:, None, :], dim=0)
    return (y * x_scale).to(out_dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, [-8, 7]) two per byte along axis 0.

    q: [K, N] -> uint8 [K/2, N] in the HALVES layout: row k in the low
    nibble, row k + K/2 in the high nibble, so a kernel's unpack of a packed
    row block gives two contiguous row blocks of the natural order."""
    K = q.shape[0]
    if K % 2:
        raise ValueError("K must be even to pack int4")
    half = K // 2
    lo = (q[:half] & 0x0F).to(torch.uint8)
    hi = (q[half:] & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: uint8 [K/2, N] -> int8 [K, N] in [-8, 7]."""
    lo = (packed & 0x0F).to(torch.int8)
    hi = ((packed >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.cat([lo, hi], dim=0)


# ---------------------------------------------------------------------------
# Activation quantization (online, per token/row)
# ---------------------------------------------------------------------------

def quantize_act_per_token(
    x: torch.Tensor, bits: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row absmax activation quant (mixlib.FindRowScale).

    x: [..., K] -> (q int8 [..., K], scale f32 [..., 1])."""
    qmax = 127.0 if bits == 8 else 7.0
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(true_div(absmax, qmax), 1e-8)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quant for KV-cache writes.
    x: [..., hd] -> (int8 [..., hd], scale f32 [...])."""
    xf = x.float()
    scale = torch.clamp_min(true_div(xf.abs().amax(dim=-1), 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# ---------------------------------------------------------------------------
# Outlier machinery (static budget)
# ---------------------------------------------------------------------------

class OutlierSet(NamedTuple):
    """Static-budget outlier channel set for one linear layer.

    ind:    [B] int32  — channel indices into K, padded with 0 beyond count
    mask:   [B] f32    — 1.0 for live entries, 0.0 for padding
    k_mask: [K] f32    — 1.0 for inlier channels, 0.0 for outlier channels
    count:  [] int32   — number of live outliers
    """

    ind: torch.Tensor
    mask: torch.Tensor
    k_mask: torch.Tensor
    count: torch.Tensor

    @property
    def budget(self) -> int:
        return self.ind.shape[0]


def empty_outlier_set(k: int, budget: int, device="cuda") -> OutlierSet:
    return OutlierSet(
        ind=torch.zeros((budget,), dtype=torch.int32, device=device),
        mask=torch.zeros((budget,), dtype=torch.float32, device=device),
        k_mask=torch.ones((k,), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def outlier_set_from_indices(ind, k: int, budget: int,
                             device="cuda") -> OutlierSet:
    """Build an OutlierSet from a concrete index list (e.g. the top-B
    calibration channels)."""
    if not isinstance(ind, torch.Tensor):
        ind = torch.tensor(ind, dtype=torch.int32)        # copies
    ind = ind.to(device=device, dtype=torch.int32).reshape(-1)
    n = ind.shape[0]
    if n > budget:
        raise ValueError(f"{n} outliers exceed budget {budget}")
    oset = empty_outlier_set(k, budget, device=ind.device)
    oset.ind[:n] = ind
    oset.mask[:n] = 1.0
    oset.k_mask[ind.long()] = 0.0
    oset.count.fill_(n)
    return oset


def extract_outliers(x: torch.Tensor, oset: OutlierSet) -> torch.Tensor:
    """Gather the outlier channels of x into a dense [..., B] block and zero
    the padding slots (mixlib.ExtractOutliersAndSetToZeros)."""
    gathered = torch.index_select(x, -1, oset.ind)
    return gathered * oset.mask.to(gathered.dtype)


def mask_inliers(x: torch.Tensor, oset: OutlierSet) -> torch.Tensor:
    """Zero the outlier channels of x (dense mask multiply)."""
    return x * oset.k_mask.to(x.dtype)


def gather_outlier_weights(w: torch.Tensor, oset: OutlierSet) -> torch.Tensor:
    """Pull the outlier rows of the [K, N] weight into a dense [B, N] block;
    padded rows are zeroed so padded activations contribute nothing."""
    rows = torch.index_select(w, 0, oset.ind)
    return rows * oset.mask[:, None].to(rows.dtype)


def top_k_outliers_from_scales(
    act_scales: torch.Tensor, n: int, k: int, budget: int
) -> OutlierSet:
    """Calibration-time outlier pick: the top-n channels by recorded
    activation absmax."""
    idx = torch.topk(act_scales.float(), n).indices
    return outlier_set_from_indices(idx, k=k, budget=budget,
                                    device=act_scales.device)


# ---------------------------------------------------------------------------
# Dequant epilogue (the reference semantics of the fused GEMM kernel)
# ---------------------------------------------------------------------------

def dequant_epilogue(
    acc_i32: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    outlier_part: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """y = acc * x_scale * w_scale (+ outlier_part) — mixlib.dequantizeInt8."""
    y = acc_i32.float() * x_scale * w_scale[None, :]
    if outlier_part is not None:
        y = y + outlier_part.float()
    return y.to(out_dtype)
