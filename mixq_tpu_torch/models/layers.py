"""Transformer building blocks (mirrors mixq_tpu/models/layers.py).

Ported: rmsnorm, rmsnorm_quant (kernel 1 on the card), unscaled neox RoPE,
a head-major KV cache written in place, and `attend`, the masked attention
that serves prefill (plain PyTorch, as JAX computes it in jnp).

The JAX cache's token-major tail window and its flush exist because a
dynamic-offset write into the big head-major cache is a whole-array pass on
the TPU. On the card a write into a [.., S, D] stripe is an ordinary strided
copy, so this cache is written in place and keeps no tail; results, not
layout, are held against the reference. The batch-major layout, ring
(sliding-window) writes, layernorm, rope scaling and ALiBi are still to be
ported (ROADMAP.md Queue A). `attend` takes gemma2's score scale, softcap
and (alternating) sliding window.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mixq_tpu_torch.kernels.rmsnorm_quant import fused_rmsnorm_quant
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                             QuantizedAct)
from mixq_tpu_torch.utils.shapes import round_up


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_quant(
    x: torch.Tensor,
    scale: torch.Tensor,
    next_params: MixLinearParams,
    next_spec: LinearSpec,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, QuantizedAct]:
    """RMSNorm fused with the next linear's activation preparation (the
    reference's layernorm_forward_cuda_extract_outliers): one pass gives the
    normed output and the quantized activation with its fp outlier slice.
    Kernel 1 on the card; `rmsnorm` + `prepare_act` arithmetic."""
    oset = next_params.outlier_set
    y, q_x, x_scale, x_out = fused_rmsnorm_quant(
        x, scale, None if oset is None else oset.k_mask, eps=eps,
        a_bits=min(next_spec.a_bit, 8),
        out_ind=None if oset is None else oset.ind,
        out_mask=None if oset is None else oset.mask)
    return y, QuantizedAct(q_x, x_scale, x_out)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 10000.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables for the given positions: ([..., dim/2] x 2).
    Unscaled rope only (rope_scaling is still to be ported)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "neox") -> torch.Tensor:
    """Rotate-half ('neox') rope on x [B, T, H, D] with cos/sin [T, D/2] or
    [B, T, D/2]; computed in f32, returned in x.dtype."""
    if style != "neox":
        raise NotImplementedError(f"rope style {style!r} is not ported")
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    if c.dim() == x.dim() - 1:
        c, s = c[None], s[None]
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache:
    """Preallocated head-major KV cache, updated in place.

    k, v: [L, n_kv, B, S, D] (bf16, or int8 with per-(token, head) scales);
    k_scale, v_scale: [L, n_kv, B, Sp] f32, Sp = S padded to a multiple of
    128 as JAX allocates them (pad slots are never written and always
    masked). `length` is the valid prefix, a host integer: the host loop
    always knows it, so no step reads it back from the card.
    """

    head_major = True

    def __init__(self, k, v, k_scale, v_scale, length: int = 0):
        self.k, self.v = k, v
        self.k_scale, self.v_scale = k_scale, v_scale
        self.length = length

    @classmethod
    def create(cls, n_layers, batch, max_seq, n_kv, head_dim,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        shape = (n_layers, n_kv, batch, max_seq, head_dim)
        sc_shape = (n_layers, n_kv, batch, round_up(max_seq, 128))
        quantized = dtype == torch.int8
        mk = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
        return cls(
            mk(shape, dtype), mk(shape, dtype),
            (torch.ones(sc_shape, dtype=torch.float32, device=device)
             if quantized else None),
            (torch.ones(sc_shape, dtype=torch.float32, device=device)
             if quantized else None))

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def batch(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def update_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor) -> "KVCache":
        """Write k/v [B, T, n_kv, D] at positions [length, length + T) of
        `layer`, in place (int8 caches quantize per (token, head)). The
        length advances once per forward, through `advance`."""
        T = k_new.shape[1]
        pos = self.length
        if pos + T > self.max_seq:
            raise ValueError(f"cache overflow: {pos} + {T} > {self.max_seq}")
        if self.quantized:
            qk, sk = Q.quantize_kv(k_new)
            qv, sv = Q.quantize_kv(v_new)
            self.k_scale[layer, :, :, pos:pos + T] = sk.permute(2, 0, 1)
            self.v_scale[layer, :, :, pos:pos + T] = sv.permute(2, 0, 1)
        else:
            qk, qv = k_new, v_new
        self.k[layer, :, :, pos:pos + T] = qk.permute(2, 0, 1, 3)
        self.v[layer, :, :, pos:pos + T] = qv.permute(2, 0, 1, 3)
        return self

    def layer_kv(self, layer: int):
        """(k, v, k_scale, v_scale) views of one layer."""
        if self.quantized:
            return (self.k[layer], self.v[layer], self.k_scale[layer],
                    self.v_scale[layer])
        return self.k[layer], self.v[layer], None, None

    def advance(self, t: int) -> "KVCache":
        self.length += t
        return self


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attend(
    q: torch.Tensor,                # [B, T, n_q, D]
    k: torch.Tensor,                # [B, S, n_kv, D]
    v: torch.Tensor,                # [B, S, n_kv, D]
    q_slot: torch.Tensor,           # [T] int — cache-slot index of each query
    kv_valid_len: int,              # number of valid slots
    kv_start: Optional[torch.Tensor] = None,   # [B] first real slot per row
    sliding_window: Optional[int] = None,      # keep kv_pos > q_slot - W
    scale: Optional[float] = None,             # default 1/sqrt(D) (gemma2:
                                               # query_pre_attn_scalar^-0.5)
    softcap: Optional[float] = None,           # gemma2: tanh(s / cap) * cap
) -> torch.Tensor:
    """Masked multi-head attention over an fp KV buffer, GQA by grouping
    query heads against their kv head, with JAX's options in JAX's order:
    the scale override replaces 1/sqrt(D), the softcap comes after the
    scale, and the window masks slots at or before q_slot - W. Operands in
    f32 (the JAX CPU path's operand type; prefill is not the
    bandwidth-bound step). The int8-scaled form over a batch-major cache and
    ALiBi are still to be ported."""
    B, T, n_q, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    groups = n_q // n_kv
    if scale is None:
        # f32 reciprocal of the f32 sqrt, as jnp computes 1 / sqrt(D)
        scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    qf = q.float().reshape(B, T, n_kv, groups, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    kv_pos = torch.arange(S, device=q.device)[None, None, :]       # [1,1,S]
    causal = kv_pos <= q_slot[None, :, None]
    mask = causal & (kv_pos < kv_valid_len)                        # [1,T,S]
    if kv_start is not None:
        mask = mask & (kv_pos >= kv_start[:, None, None])          # [B,T,S]
    if sliding_window is not None:
        mask = mask & (kv_pos > q_slot[None, :, None] - sliding_window)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(B, T, n_q, D).to(q.dtype)

