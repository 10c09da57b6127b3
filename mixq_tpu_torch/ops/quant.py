"""Core quantization primitives in PyTorch (mirrors mixq_tpu/ops/quant.py).

Every function repeats the JAX arithmetic in the same order and dtypes, so
the integer results are bit-equal: `torch.round` and `jnp.round` both round
half to even, and each division is an IEEE f32 division on both sides.

Ported here: int8, int4 and group-wise weight quantization, int4 packing in
the halves layout, per-token activation and per-(token, head) KV
quantization, the static-budget outlier set and its helpers, the dequant
epilogue, the grouped int8 GEMM reference, and the online outlier detector
(`detect_new_outliers`, `detect_new_outliers_from_absmax`). Every pick of
channels by magnitude goes through `top_indices`, which orders ties as
jax.lax.top_k does (the lower index first). QUIK's asymmetric per-row
activation quantizer (`quantize_act_asymmetric`) and its zero-point
column sums (`reduced_weight_rowsum`) divide and round as JAX's do.
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


def quantize_act_asymmetric(
    x: torch.Tensor, bits: int = 4
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Asymmetric per-row activation quant (QUIK).

    x: [..., K] -> (q int8 [..., K], scale f32 [..., 1], zero f32 [..., 1])
    with x ~ (q + zero) * scale and q in [-2^(b-1), 2^(b-1) - 1]: the
    range's low end is reached (-8 at 4 bits, -128 at 8), which the
    symmetric quantizer never gives. `zero` is not an integer. A row of
    zeros (every channel an outlier) gives scale 1e-8, zero 2^(b-1) and q
    at the low end."""
    qlevels = 2.0 ** bits - 1.0
    xf = x.float()
    xmin = xf.amin(dim=-1, keepdim=True)
    xmax = xf.amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(true_div(xmax - xmin, qlevels), 1e-8)
    lo = -(2.0 ** (bits - 1))
    zero = xmin / scale - lo
    q = torch.clamp(torch.round(xf / scale - zero), lo, -lo - 1)
    return q.to(torch.int8), scale, zero


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


def absmax_channels(x: torch.Tensor) -> torch.Tensor:
    """Per-channel absolute max over every leading axis (batch, time), in
    f32: the calibration and warmup statistic."""
    return x.float().abs().reshape(-1, x.shape[-1]).amax(dim=0)


def detect_new_outliers(x: torch.Tensor, oset: OutlierSet,
                        sigma: float) -> OutlierSet:
    """Online outlier predictor update: the channels where any |x| >
    sigma that are not in the set yet, appended after its live entries up
    to the budget (see detect_new_outliers_from_absmax)."""
    return detect_new_outliers_from_absmax(absmax_channels(x), oset, sigma)


def detect_new_outliers_from_absmax(ch_max: torch.Tensor, oset: OutlierSet,
                                    sigma: float) -> OutlierSet:
    """`detect_new_outliers` from precomputed per-channel absmax (the
    statistic of forward(collect_stats=True)). Static shapes, no host
    read: new channels are ranked by magnitude (ties by the lower index,
    `top_indices`) and the first min(new, budget - count) are written at
    slots count, count + 1, ...; the rest of the ranking is dropped."""
    k = ch_max.shape[0]
    budget = oset.budget
    is_new = (ch_max > sigma) & (oset.k_mask > 0.5)              # [K]
    top_idx = top_indices(ch_max.float().masked_fill(~is_new, -float("inf")),
                          budget)
    n_new = is_new.sum().to(torch.int32)
    n_add = torch.minimum(n_new, budget - oset.count)
    slots = torch.arange(top_idx.shape[0], dtype=torch.int32,
                         device=ch_max.device)
    take = slots < n_add
    # writes that are not taken go to one spare slot past the end
    dest = torch.where(take, oset.count + slots, budget).long()
    ind = torch.cat([oset.ind, oset.ind.new_zeros(1)])
    ind.scatter_(0, dest, top_idx.to(torch.int32))
    mask = torch.cat([oset.mask, oset.mask.new_zeros(1)])
    mask.scatter_(0, dest, torch.ones_like(dest, dtype=mask.dtype))
    upd_k = torch.zeros(k + 1, dtype=torch.float32, device=ch_max.device)
    upd_k.scatter_(0, torch.where(take, top_idx, k),
                   torch.ones_like(top_idx, dtype=torch.float32))
    return OutlierSet(ind[:budget], mask[:budget],
                      oset.k_mask * (1.0 - upd_k[:k]), oset.count + n_add)


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


def top_indices(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the n largest scores, largest first, ties by the lower
    index first, as jax.lax.top_k orders them (torch.topk does not): a
    stable descending sort, on the CPU and the card alike."""
    return torch.sort(scores, descending=True, stable=True).indices[:n]


def top_k_outliers_from_scales(
    act_scales: torch.Tensor, n: int, k: int, budget: int
) -> OutlierSet:
    """Calibration-time outlier pick: the top-n channels by recorded
    activation absmax, ties by the lower index."""
    idx = top_indices(act_scales.float(), n)
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


def reduced_weight_rowsum(q_w: torch.Tensor) -> torch.Tensor:
    """QUIK's zero-point correction term: the column sums over K of the int
    weight values. q_w: int8 [K, N] (packed W4 unpacked first) -> f32
    [N]."""
    return q_w.to(torch.int32).sum(dim=0).float()
