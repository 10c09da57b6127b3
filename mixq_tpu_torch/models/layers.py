"""Transformer building blocks (mirrors mixq_tpu/models/layers.py).

Ported: rmsnorm, rmsnorm_quant (kernel 1 on the card), layernorm (the
LayerNorm families: falcon, gptj, opt, starcoder2; torch glue, as JAX has
no Pallas LayerNorm), neox and gptj (rotate every two: gptj, chatglm)
RoPE with HF's linear, llama3 and longrope scaling and partial rotary
dims,
the KV cache in JAX's two layouts (batch-major, with ring writes for
sliding-window models, and head-major), written in place, and `attend`, the
masked attention that serves prefill (plain PyTorch, as JAX computes it in
jnp): over a chunk's own k/v, or over a batch-major cache with its int8
scales and ring positions, and the speculative verify over a batch-major
pool. `KVCache.update_layer_slots` is the continuous-batching pool's write
at per-row positions: the decode step's token, or the verify's span.

The JAX cache's token-major tail window and its flush exist because a
dynamic-offset write into the big head-major cache is a whole-array pass on
the TPU. On the card a write into a [.., S, D] stripe is an ordinary strided
copy, so this cache is written in place and keeps no tail; results, not
layout, are held against the reference. `attend_chunked` is still to be
ported (ROADMAP.md Queue A item 6). `attend`
takes gemma2's score scale, softcap and (alternating) sliding window, and
ALiBi's bias (`alibi_slopes`; Baichuan-13B, whose rope style "none" is the
identity rotation; falcon's pre-scaled slopes, `falcon_alibi_slopes`).
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from mixq_tpu_torch.kernels.rmsnorm_quant import fused_rmsnorm_quant
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                             QuantizedAct)
from mixq_tpu_torch.utils.arith import constant, true_div
from mixq_tpu_torch.utils.shapes import round_up


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm in f32 (mixq_tpu/models/layers.py:43-52): the mean and
    the population variance over the last axis, the scale and the
    optional bias, rounded to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


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

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 10000.0,
                 scaling: Optional[tuple] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 cos/sin tables for the given positions: ([..., dim/2] x 2), in
    the operation order of mixq_tpu/models/layers.py:80-124. `scaling` is
    HF's rope_scaling as the decoder builds it (None, or):
      ("linear", f)                      every frequency divided by f;
      ("llama3", f, low, high, orig)     Llama-3.1+: wavelengths past
          orig / low divided by f, under orig / high kept, interpolated
          between (transformers' _compute_llama3_parameters);
      ("longrope", factors, att)         phi3: frequency i divided by
          factors[i], both tables scaled by the attention factor att.
    Python numbers enter as f32, as JAX's weak types do, and every
    division is an f32 division."""
    dev = positions.device
    f32 = lambda v: constant(float(v), torch.float32, dev)
    exps = true_div(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=dev), dim)
    inv_freq = 1.0 / (theta ** exps)
    att = None
    if scaling is not None:
        kind = scaling[0]
        if kind == "linear":
            inv_freq = true_div(inv_freq, scaling[1])
        elif kind == "llama3":
            import math

            _, factor, low_f, high_f, orig = scaling
            low_wl, high_wl = orig / low_f, orig / high_f
            wavelen = f32(2.0 * math.pi) / inv_freq
            scaled = true_div(inv_freq, factor)
            smooth = true_div(f32(orig) / wavelen - f32(low_f),
                              high_f - low_f)
            smoothed = (f32(1.0) - smooth) * scaled + smooth * inv_freq
            inv_freq = torch.where(
                wavelen > f32(low_wl), scaled,
                torch.where(wavelen < f32(high_wl), inv_freq, smoothed))
        elif kind == "longrope":
            _, factors, att = scaling
            inv_freq = inv_freq / _rope_factors(tuple(factors), dev)
        else:
            raise ValueError(f"unsupported rope scaling {kind}")
    angles = positions.float()[..., None] * inv_freq
    if att is not None:
        return torch.cos(angles) * f32(att), torch.sin(angles) * f32(att)
    return torch.cos(angles), torch.sin(angles)


@functools.lru_cache(maxsize=16)
def _rope_factors(factors: Tuple[float, ...], device: torch.device
                  ) -> torch.Tensor:
    """longrope's per-frequency factors as an f32 tensor on `device`, made
    once per list and device (as alibi_slopes is: a CUDA graph of the
    decode step cannot hold the host-to-device copy). Only read."""
    with torch.inference_mode(False):
        return torch.tensor(factors, dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               style: str = "neox",
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rope on x [B, T, H, D] with cos/sin [T, rot/2] or [B, T, rot/2];
    computed in f32, returned in x.dtype (mixq_tpu/models/layers.py:
    127-164): 'neox' rotates halves, 'gptj' (gptj, chatglm) every two
    neighbours, (x[2i], x[2i+1]) by angle i. With `rotary_dim` rot < D
    (partial rotary: gptj, chatglm, Phi-4-mini-class phi3) only the first
    rot values of each head rotate and the rest pass through. Style "none"
    (ALiBi and learned-position models) is x itself: JAX rotates by cos =
    1, sin = 0 (mixq_tpu/models/decoder.py:455-456), which gives back x."""
    if style == "none":
        return x
    if style not in ("neox", "gptj"):
        raise ValueError(f"unknown rope style {style}")
    D = x.shape[-1]
    rot = rotary_dim or D
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    if c.dim() == x.dim() - 1:
        c, s = c[None], s[None]
    xf = x[..., :rot].float()
    if style == "neox":
        x1, x2 = torch.chunk(xf, 2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                          dim=-1).reshape(xf.shape)
    out = out.to(x.dtype)
    if rot < D:
        out = torch.cat([out, x[..., rot:]], dim=-1)
    return out


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def alibi_slopes(n_heads: int, device: torch.device) -> torch.Tensor:
    """[n_heads] f32 per-head ALiBi slopes on `device` (mirrors
    mixq_tpu/models/layers.py:216-235, in its Python-float arithmetic): the
    geometric sequence from 2^(-8/closest_pow2), with interleaved extra
    slopes for a head count that is not a power of two. Made once per head
    count and device, as utils.arith.constant is: a CUDA graph of the
    decode step cannot hold the host-to-device copy, so it reads the
    tensor the first, eager forward made. Only read, never written."""
    import math

    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** i
                   for i in range(1, 2 * (n_heads - closest) + 1, 2)]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=16)
def falcon_alibi_slopes(n_heads: int, head_dim: int,
                        device: torch.device) -> torch.Tensor:
    """falcon's slopes: alibi_slopes divided by f32 sqrt(head_dim), as
    mixq_tpu/models/decoder.py:489-494 pre-scales them (falcon adds the
    bias before its 1/sqrt(head_dim) score scale; `attend` and the
    kernels add it after the scale). Made once per shape and device, as
    alibi_slopes is."""
    with torch.inference_mode(False):
        root = torch.sqrt(torch.tensor(float(head_dim),
                                       dtype=torch.float32))
        return (alibi_slopes(n_heads, torch.device("cpu")) / root).to(device)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache:
    """Preallocated KV cache, updated in place, in either of JAX's layouts.

    batch-major (the default, as in JAX): k, v [L, B, S, n_kv, D] (bf16, or
    int8 with per-(token, head) scales k_scale, v_scale [L, B, S, n_kv]
    f32); decode attention over it is kernel 8 (`decode_attention`).
    head-major (the flash layout): k, v [L, n_kv, B, S, D]; scales
    [L, n_kv, B, Sp] f32, Sp = S padded to a multiple of 128 as JAX
    allocates them (pad slots are never written and always masked); decode
    attention over it is kernel 3 (`flash_decode_attention`).

    `length` is the valid prefix, a 0-dim int32 tensor on the cache's
    device, as in JAX: a decode step computes its slots, positions and
    lengths from it on the device, so a CUDA graph of the step replays at
    the length of each replay. `host_length` mirrors it on the host for the
    guards that stay host-side (overflow, the fresh-cache and ring checks);
    eager forwards advance both, and a caller that replays a captured step
    advances the mirror itself. With ring writes (a sliding-window model on
    the batch-major cache) it counts absolute positions, and position p
    lives in slot p % S.
    """

    def __init__(self, k, v, k_scale, v_scale, length: int = 0,
                 head_major: bool = False):
        self.k, self.v = k, v
        self.k_scale, self.v_scale = k_scale, v_scale
        self.length = torch.full((), length, dtype=torch.int32,
                                 device=k.device)
        self.host_length = length
        self.head_major = head_major

    @classmethod
    def create(cls, n_layers, batch, max_seq, n_kv, head_dim,
               dtype=torch.bfloat16, head_major: bool = False,
               device="cuda") -> "KVCache":
        if head_major:
            shape = (n_layers, n_kv, batch, max_seq, head_dim)
            sc_shape = (n_layers, n_kv, batch, round_up(max_seq, 128))
        else:
            shape = (n_layers, batch, max_seq, n_kv, head_dim)
            sc_shape = shape[:-1]
        quantized = dtype == torch.int8
        mk = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
        ones = lambda: (torch.ones(sc_shape, dtype=torch.float32,
                                   device=device) if quantized else None)
        return cls(mk(shape, dtype), mk(shape, dtype), ones(), ones(),
                   head_major=head_major)

    @property
    def max_seq(self) -> int:
        return self.k.shape[3] if self.head_major else self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[2] if self.head_major else self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def set_length(self, n: int) -> "KVCache":
        """Set the valid prefix: the device length and its host mirror."""
        self.length.fill_(n)
        self.host_length = n
        return self

    def slots(self, T: int, ring: bool = False) -> torch.Tensor:
        """[T] int64: the slots of positions [length, length + T), read from
        the device length (% S in ring mode)."""
        pos = self.length + torch.arange(T, device=self.k.device)
        return pos % self.max_seq if ring else pos

    def update_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, ring: bool = False,
                     slots: Optional[torch.Tensor] = None) -> "KVCache":
        """Write k/v [B, T, n_kv, D] at positions [length, length + T) of
        `layer`, in place (int8 caches quantize per (token, head)), through
        `index_copy_` at the device slots `slots(T, ring)` (a forward
        computes them once for all its layers). The length advances once
        per forward, through `advance`.

        ring=True (sliding-window models on the batch-major cache): position
        p goes to slot p % S, so a window-sized cache serves unbounded
        decode, a chunk that straddles the wrap included. Outside ring mode
        a write past S raises (checked on the host mirror)."""
        T = k_new.shape[1]
        S = self.max_seq
        if not ring and self.host_length + T > S:
            raise ValueError(f"cache overflow: {self.host_length} + {T} > {S}")
        if slots is None:
            slots = self.slots(T, ring)
        if self.quantized:
            qk, sk = Q.quantize_kv(k_new)
            qv, sv = Q.quantize_kv(v_new)
        else:
            qk, qv, sk, sv = k_new, v_new, None, None
        # the sequence axis of each buffer's layer, and [B, T, n_kv(, D)] in
        # that buffer's layout
        axis = 2 if self.head_major else 1
        kv_form = ((lambda x: x.permute(2, 0, 1, 3)) if self.head_major
                   else (lambda x: x))
        sc_form = ((lambda x: x.permute(2, 0, 1)) if self.head_major
                   else (lambda x: x))
        writes = [(self.k, kv_form(qk)), (self.v, kv_form(qv))]
        if self.quantized:
            writes += [(self.k_scale, sc_form(sk)),
                       (self.v_scale, sc_form(sv))]
        for buf, val in writes:
            buf[layer].index_copy_(axis, slots, val.to(buf.dtype))
        return self

    def update_layer_slots(self, layer: int, k_new: torch.Tensor,
                           v_new: torch.Tensor, slot_lengths: torch.Tensor,
                           ring: bool = False) -> "KVCache":
        """The continuous-batching write (JAX's update_layer_slots,
        mixq_tpu/models/layers.py:591-650, on a cache without its tail):
        row b's k/v [B, T, n_kv, D] goes to positions slot_lengths[b] ..
        slot_lengths[b] + T - 1 ([B] int, on the device) of `layer`, in
        place, int8 quantized per (token, head) as update_layer does; % S
        on a ring. T = 1 is the decode step, T > 1 the speculative verify's
        span. The scalar length is not read or moved. No host check runs,
        so that a CUDA graph holds the write: the caller keeps every span
        inside the cache (the windows clamp lengths at S - 1, the spec
        windows at S - T, as JAX's do; JAX drops a span's overflow)."""
        B, T = k_new.shape[:2]
        pos = (slot_lengths.long()[:, None]
               + torch.arange(T, device=slot_lengths.device)[None])
        if ring:
            pos = pos % self.max_seq
        rows = torch.arange(B, device=pos.device)[:, None]
        if self.quantized:
            qk, sk = Q.quantize_kv(k_new)
            qv, sv = Q.quantize_kv(v_new)
            writes = [(self.k, qk), (self.v, qv), (self.k_scale, sk),
                      (self.v_scale, sv)]
        else:
            writes = [(self.k, k_new), (self.v, v_new)]
        for buf, val in writes:            # val: [B, T, n_kv(, D)]
            if self.head_major:            # [n_kv, B, S(, D)] per layer
                buf[layer][:, rows, pos] = val.movedim(2, 0).to(buf.dtype)
            else:                          # [B, S, n_kv(, D)] per layer
                buf[layer][rows, pos] = val.to(buf.dtype)
        return self

    def layer_kv(self, layer: int):
        """(k, v, k_scale, v_scale) views of one layer."""
        if self.quantized:
            return (self.k[layer], self.v[layer], self.k_scale[layer],
                    self.v_scale[layer])
        return self.k[layer], self.v[layer], None, None

    def advance(self, t: int) -> "KVCache":
        """Advance the device length in place, and its host mirror."""
        self.length.add_(t)
        self.host_length += t
        return self


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def ring_positions(kv_len, S: int, device) -> torch.Tensor:
    """[B?, S] absolute position held in each slot of a ring cache whose
    valid length (absolute) is kv_len (an int or [B]): s + S * floor((len -
    1 - s) / S), negative for a slot never written (JAX's attend)."""
    s = torch.arange(S, device=device)
    lens = torch.as_tensor(kv_len, device=device).reshape(-1, 1)
    return s + S * torch.div(lens - 1 - s, S, rounding_mode="floor")


def attend(
    q: torch.Tensor,                # [B, T, n_q, D]
    k: torch.Tensor,                # [B, S, n_kv, D]
    v: torch.Tensor,                # [B, S, n_kv, D]
    q_slot: torch.Tensor,           # [T] or [B, T] int: absolute position of
                                    # each query (per row for per-row lengths)
    kv_valid_len,                   # int or [B]: valid (absolute) length
    kv_start: Optional[torch.Tensor] = None,   # [B] first real position
    sliding_window: Optional[int] = None,      # keep kv_pos > q_slot - W
    k_scale: Optional[torch.Tensor] = None,    # [B, S, n_kv] (int8 KV)
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,             # default 1/sqrt(D) (gemma2:
                                               # query_pre_attn_scalar^-0.5)
    softcap: Optional[float] = None,           # gemma2: tanh(s / cap) * cap
    ring: bool = False,                        # ring cache: slot s holds
                                               # ring_positions(len)[s]
    alibi: Optional[torch.Tensor] = None,      # [n_q] f32 ALiBi slopes
) -> torch.Tensor:
    """Masked multi-head attention over a KV buffer (a prefill chunk's own
    k/v, or a batch-major cache layer), GQA by grouping query heads against
    their kv head, with JAX's options in JAX's order: the scale override
    replaces 1/sqrt(D), the int8 cache's k_scale multiplies the scores after
    the contraction, the softcap comes after both, the window masks
    positions at or before q_slot - W, and v_scale multiplies the
    normalised probabilities. ALiBi adds slope * f32(kv_pos - q_pos) to the
    scores after the softcap and before the mask (JAX's relative form, on
    ring positions too). Masks are taken in absolute positions, so a
    ring cache is read as JAX reads it. Operands in f32 (the JAX CPU path's
    operand type; prefill is not the bandwidth-bound step). K and V are
    each converted to f32 once, straight into [B, n_kv, S, D], and both
    products are batched matmuls over that layout, the query heads of a kv
    head and the queries stacked as rows (a speculative verify's few
    queries per row read a whole pool layer this way without a second f32
    copy of it)."""
    B, T, n_q, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    groups = n_q // n_kv
    if scale is None:
        # f32 reciprocal of the f32 sqrt, as jnp computes 1 / sqrt(D)
        scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    def f32_heads(a):                      # [B, S, n_kv, D] -> [B, n_kv, S, D]
        return a.permute(0, 2, 1, 3).to(torch.float32,
                                        memory_format=torch.contiguous_format)

    qh = q.float().reshape(B, T, n_kv, groups, D).permute(0, 2, 3, 1, 4)
    scores = torch.matmul(qh.reshape(B, n_kv, groups * T, D),
                          f32_heads(k).transpose(-1, -2)).view(
                              B, n_kv, groups, T, S) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if softcap is not None:
        scores = torch.tanh(true_div(scores, softcap)) * softcap
    q_pos = (q_slot if q_slot.dim() == 2 else q_slot[None])[:, :, None]
    lens = torch.as_tensor(kv_valid_len, device=q.device).reshape(-1, 1, 1)
    if ring:
        kv_pos = ring_positions(kv_valid_len, S, q.device)[:, None, :]
    else:
        kv_pos = torch.arange(S, device=q.device)[None, None, :]   # [1,1,S]
    if alibi is not None:
        # [n_q] slopes grouped to [n_kv, groups], as the scores are
        dist = (kv_pos - q_pos).float()                            # [B?,T,S]
        scores = scores + (alibi.reshape(n_kv, groups)[:, :, None, None]
                           * dist[:, None, None])
    mask = (kv_pos <= q_pos) & (kv_pos < lens)                     # [B?,T,S]
    if ring:
        mask = mask & (kv_pos >= 0)        # never-written slots come out < 0
    if kv_start is not None:
        mask = mask & (kv_pos >= kv_start[:, None, None])          # [B,T,S]
    if sliding_window is not None:
        mask = mask & (kv_pos > q_pos - sliding_window)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.matmul(probs.reshape(B, n_kv, groups * T, S),
                       f32_heads(v)).view(B, n_kv, groups, T, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, n_q, D).to(q.dtype)
