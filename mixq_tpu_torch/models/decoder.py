"""Decoder-only transformer over quantized parameters (mirrors
mixq_tpu/models/decoder.py).

A model is a plain tensor container (`DecoderParams`) plus `forward`; the
per-linear precision policy and the decode-attention choice are a static
`DecoderSpecs`. Ported: the llama family (RMSNorm, gated SiLU MLP, GQA,
neox RoPE with HF's linear, llama3 (Llama-3.1) or longrope (phi3) scaling
and partial rotary dims, or ALiBi with rope style "none": Baichuan-13B),
qwen2 (q/k/v bias), qwen3 (QK-norm: a per-head RMSNorm on q and k before
RoPE), phi3 (packed q/k/v and gate/up at load, head dim 96), gemma (the
embedding multiplier, the GeGLU MLP, (1 + w) norms folded at load),
mistral (a uniform sliding window), gemma2 (the
embedding multiplier, post-attention and post-FFW norms, the GeGLU MLP with
the tanh-GELU fused into the gate GEMM, the query_pre_attn_scalar score
scale, the attention and final-logit softcaps, the tied head, and
alternating sliding windows), and the LayerNorm families: falcon
(LayerNorm with bias, the parallel block sharing one pre-norm, or the new
decoder's own ln_mlp, a GELU MLP without a gate, MQA / GQA up to 71 query
heads a kv head, ALiBi with slopes pre-scaled by 1/sqrt(head_dim)), gptj
(the parallel block, gptj-style RoPE on a partial rotary dim, gelu_new),
opt (learned positions, per row in slot mode; relu after the up linear),
starcoder2 (biases on every linear and norm, gelu_pytorch_tanh) and
chatglm (RMSNorm, gptj-style RoPE on half the head, q/k/v bias), and the
sparse-MoE families, mixtral and qwen2_moe (ops/moe.py: the routed experts
on kernel 2's expert mode, qwen2-moe's sigmoid-gated shared expert), on the
python-loop-over-layers runtime, over
either KV-cache layout, dispatched on the cache as JAX does:

  batch-major cache (JAX's default; a uniform window writes it as a ring):
      prefill (T > 1, any chunk, also over a populated cache): the chunk is
      written, then `attend` over the cache layer with its int8 scales and
      ring positions (plain PyTorch, as JAX computes it in jnp);
      decode (T = 1): the token is written, then kernel 8
      (`decode_attention`) attends over the layer, from the layer's window
      start max(kv_start, kv_len - W);
      speculative verify (T > 1 in slot mode): the span is written, then
      `attend` with per-row query positions;
  head-major cache (the flash layout):
      prefill (T > 1, fresh cache): attention over the chunk's own k/v
      while the chunk is written into the cache;
      decode (T = 1): the token is written, then kernel 3 attends over the
      cache, from the same window start;
      speculative verify (T > 1 in slot mode): the span is written, then
      kernel 3 once per verify token at its per-row length.

Which layout a cache has is the engine's choice, by
kernels.flash_decode.use_head_major_cache on `DecoderSpecs.attn_impl`.

The precision of each linear slot comes from `DecoderSpecs` (e.g. from
quantize.resolve_specs). As in JAX, only a MIX linear group (q/k/v, up/gate)
shares one prepared activation, made by the fused norm + quantization
(kernel 1; after a LayerNorm, `layernorm` then `prepare_act` in torch ops,
as JAX has no Pallas LayerNorm); FP16 and WEIGHT_ONLY linears take the
plain norm output. A parallel block's MLP quantizes the attention's
pre-norm output again with its own outlier set (JAX's mixed_linear on
h_ln). A non-gated MLP fuses its GELU into the up GEMM (relu runs after
it); with a bias the GEMM returns f32 and the bias and activation are
added outside (ops/mixed_linear.py). Per
block on the card, W8A8: kernel 1 twice, the int8 GEMM seven times (q, k,
v, o, up, gate+SiLU or gemma2's gate+GELU-tanh, down), or for an MoE
block kernel 1 once (before q/k/v; the MLP takes the plain norm, its
experts quantizing per (expert, slot) row), kernel 2 four times (q, k, v,
o), its expert mode three times (gate, up, down over every expert) and
qwen2-moe's shared expert three kernel-2 launches more; W4A4 (reference
policy): kernel 1 twice, five packed-W4 GEMMs (q, k, v, up, gate) and two
W8A8 ones (o, down); W8A16: seven a16 GEMMs and no kernel 1; and one decode
attention per decode step (kernel 3 or 8; gemma2: in its softcap mode;
ALiBi models: in its ALiBi mode, the slopes made once per head count and
device, so a captured step reads the eager step's).
`forward(..., collect_stats=True)` also returns each linear group's input
channel absmax (calibration and the online predictor's warmup read it;
"full" gives the raw inputs); off, the forward computes none of it.
`forward(..., slot_lengths=[B])` is the continuous-batching pool's step at
per-row positions (engine/batching.py): T=1 is the decode step, T>1 the
speculative verify, whose T tokens are written first; on the batch-major
cache `attend` then takes the [B, T] query positions (JAX's jnp path, f32),
on the head-major cache kernel 3 runs once per verify token t at per-row
length slot_lengths + t + 1 (JAX's one flash call per t over its tail,
decoder.py:611-646; the port reads its main cache). The stacked `lax.scan`
runtime and the other layer ops of ROADMAP.md Queue A item 6 raise
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.kernels.decode_attention import decode_attention
from mixq_tpu_torch.kernels.flash_decode import flash_decode_attention
from mixq_tpu_torch.models.layers import (KVCache, alibi_slopes,
                                          apply_rope, attend,
                                          falcon_alibi_slopes, layernorm,
                                          rmsnorm, rmsnorm_quant,
                                          rope_cos_sin)
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.moe import MoEParams, expert_from_float, moe_mlp
from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                             from_float, mixed_linear,
                                             mixed_linear_prepared,
                                             prepare_act)
from mixq_tpu_torch.utils.arith import constant, true_div


class AttnParams(NamedTuple):
    """q/k/v as separate linears sharing ONE quantized activation."""

    wq: MixLinearParams            # [H, nq*hd]
    wk: MixLinearParams            # [H, nkv*hd]
    wv: MixLinearParams            # [H, nkv*hd]
    wo: MixLinearParams            # [nq*hd, H]
    q_norm: Optional[torch.Tensor] = None   # [hd] qwen3 QK-norm scales
    k_norm: Optional[torch.Tensor] = None


class MLPParams(NamedTuple):
    up: Optional[MixLinearParams]    # [H, I]; None for sparse-MoE blocks
    gate: Optional[MixLinearParams]  # [H, I]
    down: Optional[MixLinearParams]  # [I, H]
    moe: Optional[MoEParams] = None  # sparse MoE: replaces up/gate/down


class BlockParams(NamedTuple):
    ln1_scale: torch.Tensor
    ln1_bias: Optional[torch.Tensor]
    attn: AttnParams
    ln2_scale: Optional[torch.Tensor]
    ln2_bias: Optional[torch.Tensor]
    mlp: MLPParams
    post_attn_norm_scale: Optional[torch.Tensor] = None   # gemma2
    post_ffw_norm_scale: Optional[torch.Tensor] = None


class DecoderParams(NamedTuple):
    embed: torch.Tensor               # [V, H]
    blocks: Tuple[BlockParams, ...]
    lnf_scale: torch.Tensor
    lnf_bias: Optional[torch.Tensor]
    lm_head: Optional[torch.Tensor]   # [H, V]; None = tied to embed
    stacked: Optional[BlockParams] = None   # scan runtime (not ported)
    pos_embed: Optional[torch.Tensor] = None  # [P, H] OPT's positions


@dataclasses.dataclass(frozen=True)
class DecoderSpecs:
    """Static per-linear precision policy, uniform across layers, and the
    decode attention: `attn_impl` "auto" (the default) or "flash" choose
    the cache layout through kernels.flash_decode.use_head_major_cache
    (head-major: kernel 3; batch-major: kernel 8), "xla" always takes the
    batch-major cache. JAX's "pallas" (superseded there) raises as in JAX;
    "xla_int8" (int8 x int8 attention over the batch-major cache) is not
    ported."""

    wqkv: LinearSpec = LinearSpec(version="FP16", w_bit=16)
    wo: LinearSpec = LinearSpec(version="FP16", w_bit=16)
    up: LinearSpec = LinearSpec(version="FP16", w_bit=16)
    gate: LinearSpec = LinearSpec(version="FP16", w_bit=16)
    down: LinearSpec = LinearSpec(version="FP16", w_bit=16)
    attn_impl: str = "auto"

    @classmethod
    def uniform(cls, spec: LinearSpec) -> "DecoderSpecs":
        gate = dataclasses.replace(spec, fuse="silu")
        return cls(wqkv=spec, wo=spec, up=spec, gate=gate, down=spec)

    @classmethod
    def fp16(cls) -> "DecoderSpecs":
        return cls.uniform(LinearSpec(version="FP16", w_bit=16))


# the name of the profiler range around each layer's prefill attention
PREFILL_ATTEND = "prefill_attend"

# the gate GEMM's epilogue for each gated-MLP activation (JAX's _mlp)
GATE_FUSE = {"silu": "silu", "gelu": "gelu", "gelu_new": "gelu_new",
              "gelu_pytorch_tanh": "gelu_new"}
# the up GEMM's epilogue of a non-gated MLP (JAX's _mlp: gelu_new for the
# tanh GELUs, else the exact one); relu runs after the GEMM
UP_FUSE = {"gelu": "gelu", "gelu_new": "gelu_new",
           "gelu_pytorch_tanh": "gelu_new", "relu": "none"}


# the rope scalings forward builds (HF's rope_scaling through config_from_hf)
ROPE_SCALINGS = (None, "linear", "llama3", "longrope")


def gated_mlp(cfg: ModelConfig) -> bool:
    """Whether the MLP has a gate (JAX's rule: gated_mlp, else silu)."""
    return (cfg.gated_mlp if cfg.gated_mlp is not None
            else cfg.hidden_act == "silu")


def _check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError on the features the port does not run:
    rope styles and scalings, norms and activations JAX's decoder does not
    have (ROADMAP.md Queue A item 6, the layer ops)."""
    acts = GATE_FUSE if gated_mlp(cfg) else UP_FUSE
    unsupported = {
        "layernorm": cfg.layernorm not in ("rmsnorm", "layernorm"),
        # ALiBi and learned-position models rotate nothing (style "none")
        "rope_style": cfg.rope_style not in ("neox", "gptj", "none"),
        # partial rotary: an even part of the head (halves or pairs)
        "rotary_dim": cfg.rotary_dim is not None and not (
            0 < cfg.rotary_dim <= cfg.head_dim_ and cfg.rotary_dim % 2 == 0),
        "hidden_act": cfg.hidden_act not in acts,
        "rope_scaling_type": cfg.rope_scaling_type not in ROPE_SCALINGS,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"model features not ported yet: {bad} (ROADMAP.md Queue A "
            "item 6: the layer ops)")


def rope_scaling(cfg: ModelConfig, max_seq: int) -> Optional[tuple]:
    """rope_cos_sin's `scaling` for a cache of `max_seq` positions, as
    mixq_tpu/models/decoder.py:430-456 builds it: longrope takes its long
    factors when the cache reaches past the pretrain length by more than
    256 positions (JAX's slack for its engines' bucketing), else the short
    ones."""
    kind = cfg.rope_scaling_type
    if kind == "llama3":
        return ("llama3", cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
                cfg.rope_high_freq_factor, cfg.rope_original_max_position)
    if kind == "linear":
        return ("linear", cfg.rope_scaling_factor)
    if kind == "longrope":
        use_long = max_seq > cfg.rope_original_max_position + 256
        return ("longrope",
                cfg.rope_long_factor if use_long else cfg.rope_short_factor,
                cfg.rope_attention_factor)
    return None


def _shares_act(spec: LinearSpec) -> bool:
    """JAX's routing rule: only MIX linears take a shared prepared
    activation; FP16, WEIGHT_ONLY and QUIK linears take the fp input."""
    return spec.version not in ("FP16", "WEIGHT_ONLY", "QUIK")


def _norm(x, scale, bias, cfg: ModelConfig):
    """The config's norm (JAX's _norm, decoder.py:160-163)."""
    if cfg.layernorm == "rmsnorm":
        return rmsnorm(x, scale, cfg.rms_norm_eps)
    return layernorm(x, scale, bias, cfg.rms_norm_eps)


def _prepare(h, lin: Optional[MixLinearParams], spec: LinearSpec):
    """A MIX linear group's shared quantized activation of h (None for
    the linears that take the fp input, and for an MoE block's MLP,
    whose experts quantize their own rows)."""
    return (prepare_act(h, lin, spec)
            if lin is not None and _shares_act(spec) else None)


def _norm_act(x, scale, bias, lin: Optional[MixLinearParams],
              spec: LinearSpec, cfg: ModelConfig):
    """The pre-linear norm; for a MIX linear group also its shared
    quantized activation: kernel 1 after an RMSNorm, `prepare_act` after
    a LayerNorm. An MoE block's MLP (lin None) takes the plain norm."""
    if lin is not None and cfg.layernorm == "rmsnorm" and _shares_act(spec):
        return rmsnorm_quant(x, scale, lin, spec, cfg.rms_norm_eps)
    h = _norm(x, scale, bias, cfg)
    return h, _prepare(h, lin, spec)


def _linear(lin, h, act, spec):
    if act is None:
        return mixed_linear(lin, h, spec)
    return mixed_linear_prepared(lin, act, spec)


def _mlp(h: torch.Tensor, act, mlp: MLPParams, specs: DecoderSpecs,
         cfg: ModelConfig, stats: Optional[dict] = None) -> torch.Tensor:
    """The MLP on its normed input h (with its shared quantized activation
    `act` on a MIX path). Gated: up and gate sharing `act`, the activation
    of `cfg.hidden_act` fused into the gate GEMM (SwiGLU, or gemma's
    GeGLU: gelu_pytorch_tanh is gelu_new), then down. Non-gated (falcon,
    gptj, opt, starcoder2; JAX's _mlp, decoder.py:205-215): the GELU fused
    into the up GEMM, relu after it, then down. Sparse MoE (JAX's _mlp,
    decoder.py:177-188): ops/moe.py::moe_mlp on the plain norm output h.
    With a `stats` dict, the inputs of up (h) and down (the inner product;
    for an MoE block h again, as JAX reports it) go into it."""
    if mlp.moe is not None:
        if stats is not None:
            stats.update(up=h, down=h)
        return moe_mlp(h, mlp.moe, specs.up, specs.down,
                       top_k=cfg.num_experts_per_tok,
                       capacity_factor=cfg.moe_capacity_factor,
                       act="silu" if cfg.hidden_act == "silu" else "gelu",
                       norm_topk=cfg.moe_norm_topk)
    if mlp.gate is not None:
        gate_fuse = GATE_FUSE[cfg.hidden_act]
        spec_gate = (specs.gate if specs.gate.fuse == gate_fuse
                     else dataclasses.replace(specs.gate, fuse=gate_fuse))
        up = _linear(mlp.up, h, act, specs.up)
        gate = _linear(mlp.gate, h, act, spec_gate)
        inner = (gate.float() * up.float()).to(up.dtype)
    else:
        spec_up = specs.up
        if spec_up.fuse == "none":
            spec_up = dataclasses.replace(spec_up,
                                          fuse=UP_FUSE[cfg.hidden_act])
        inner = _linear(mlp.up, h, act, spec_up)
        if cfg.hidden_act == "relu":
            inner = torch.clamp_min(inner, 0)
    if stats is not None:
        stats.update(up=h, down=inner)
    return mixed_linear(mlp.down, inner, specs.down)


def block_core(
    x: torch.Tensor,               # [B, T, H]
    bp: BlockParams,
    kv_apply,                      # (q [B,T,nq,hd], k, v) -> attn [B,T,nq,hd]
    cos: torch.Tensor,
    sin: torch.Tensor,
    specs: DecoderSpecs,
    cfg: ModelConfig,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """One decoder block, with the KV-cache strategy injected: sequential
    (x + attention, then + MLP of its own norm), or parallel (falcon,
    gptj: x + attention + MLP of the same pre-norm output, or of the new
    decoder's own ln_mlp). With a `stats` dict, the input of each linear
    group goes into it under its slot: "wqkv" (the normed x; on a MIX path
    kernel 1's y), "wo" (the attention output), "up" and "down" (see
    _mlp)."""
    B, T, _ = x.shape
    n_q, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim_)
    h_ln, act = _norm_act(x, bp.ln1_scale, bp.ln1_bias, bp.attn.wq,
                          specs.wqkv, cfg)
    q = _linear(bp.attn.wq, h_ln, act, specs.wqkv).reshape(B, T, n_q, hd)
    k = _linear(bp.attn.wk, h_ln, act, specs.wqkv).reshape(B, T, n_kv, hd)
    v = _linear(bp.attn.wv, h_ln, act, specs.wqkv).reshape(B, T, n_kv, hd)
    if bp.attn.q_norm is not None:
        # qwen3's QK-norm: a per-head RMSNorm over head_dim before RoPE
        q = rmsnorm(q, bp.attn.q_norm, cfg.rms_norm_eps)
        k = rmsnorm(k, bp.attn.k_norm, cfg.rms_norm_eps)
    q = apply_rope(q, cos, sin, cfg.rope_style, cfg.rotary_dim)
    k = apply_rope(k, cos, sin, cfg.rope_style, cfg.rotary_dim)
    attn = kv_apply(q, k, v).reshape(B, T, n_q * hd)
    # o_proj quantizes its own input (the reference's unfused call)
    attn_out = mixed_linear(bp.attn.wo, attn, specs.wo)
    if stats is not None:
        stats.update(wqkv=h_ln, wo=attn)
    if bp.post_attn_norm_scale is not None:      # gemma2 pre-residual norms
        attn_out = rmsnorm(attn_out, bp.post_attn_norm_scale,
                           cfg.rms_norm_eps)
    if cfg.parallel_attn_mlp:
        # JAX's parallel block (decoder.py:325-331): falcon-7b and gptj
        # share the attention's pre-norm, quantized again with the MLP's
        # own outlier set; falcon's new decoder has its own ln_mlp
        if bp.ln2_scale is None:
            h2, act2 = h_ln, _prepare(h_ln, bp.mlp.up, specs.up)
        else:
            h2, act2 = _norm_act(x, bp.ln2_scale, bp.ln2_bias, bp.mlp.up,
                                 specs.up, cfg)
        mlp_out = _mlp(h2, act2, bp.mlp, specs, cfg, stats)
        return x + attn_out.to(x.dtype) + mlp_out.to(x.dtype)
    x = x + attn_out.to(x.dtype)
    h2, act2 = _norm_act(x, bp.ln2_scale, bp.ln2_bias, bp.mlp.up, specs.up,
                         cfg)
    mlp_out = _mlp(h2, act2, bp.mlp, specs, cfg, stats)
    if bp.post_ffw_norm_scale is not None:
        mlp_out = rmsnorm(mlp_out, bp.post_ffw_norm_scale, cfg.rms_norm_eps)
    return x + mlp_out.to(x.dtype)


def lm_head_f32(params: DecoderParams, specs: DecoderSpecs) -> torch.Tensor:
    """The head [H, V] (the embedding's transpose when tied) rounded to the
    activation dtype and widened to f32: the operand of JAX's
    jnp.dot(bf16, bf16, preferred_element_type=f32), whose products of the
    bf16-rounded operands are exact in f32. The engine widens it once."""
    head = params.lm_head if params.lm_head is not None else params.embed.T
    return head.to(specs.wqkv.odtype).float()


def _check_attn_impl(attn_impl: str) -> None:
    if attn_impl == "pallas":
        # JAX's message (decoder.py:558-563)
        raise ValueError(
            'attn_impl="pallas" (ops/pallas/decode_attention.py) was '
            'measured VPU-bound and superseded by attn_impl="flash" '
            "(ops/pallas/flash_decode.py); the old kernel is kept as a "
            "tests-only reference implementation")
    if attn_impl == "xla_int8":
        raise NotImplementedError(
            'attn_impl="xla_int8" (int8 x int8 attention over the '
            "batch-major cache) is not ported")
    if attn_impl not in ("auto", "flash", "xla"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")


def window_start(kv_start: Optional[torch.Tensor], kv_len: torch.Tensor,
                 window: Optional[int]):
    """The first position the T=1 query at kv_len - 1 ([B] int32) attends on
    a layer with `window` (attend's mask keeps kv_pos > q_pos - W):
    max(kv_start, kv_len - W, 0), as JAX passes the flash kernel its start
    (decoder.py:549-556), on the device; kv_start itself without a
    window."""
    if window is None:
        return kv_start
    ws = torch.clamp_min(kv_len - window, 0)
    return ws if kv_start is None else torch.maximum(kv_start, ws)


def writes_ring(cfg: ModelConfig, cache: KVCache) -> bool:
    """Whether a forward writes `cache` as a ring: a uniform window
    reclaims slots on the batch-major cache (JAX's ring)."""
    return (cfg.sliding_window is not None and not cache.head_major
            and cfg.sliding_window_pattern == 1)


def forward(
    params: DecoderParams,
    tokens: torch.Tensor,          # [B, T] int
    cache: KVCache,
    specs: DecoderSpecs,
    cfg: ModelConfig,
    kv_start: Optional[torch.Tensor] = None,   # [B] int32 first real slot
    *,
    head_f32: Optional[torch.Tensor],          # lm_head_f32(params, specs)
    collect_stats=False,
    slot_lengths: Optional[torch.Tensor] = None,   # [B] int32 per-row
                                                   # positions (CB pool)
):
    """Run the decoder on a token chunk starting at cache.length.

    Returns (logits [B, T, V] f32, the cache, written in place with its
    length advanced by T). T = 1 is a decode step; T > 1 is a prefill chunk
    (on a head-major cache only on a fresh one). `head_f32` is the head
    widened once by the caller (the engine holds it); None skips the final
    norm and the head and returns None for the logits (an admission
    prefill, whose logits nothing reads, as JAX's CB prefill returns only
    the cache).

    slot_lengths (continuous batching, JAX's slot mode, decoder.py:368-424):
    row b's T tokens sit at positions slot_lengths[b] .. + T - 1: their
    RoPE positions, their KV write (update_layer_slots) and their
    attention lengths are per row, on the device, and the cache's scalar
    length is neither read nor moved. T = 1 is the decode step; T > 1 the
    speculative verify (query t attends up to slot_lengths[b] + t + 1).

    collect_stats=True also returns, third, each linear group's input
    channel absmax over batch and time, {"{layer}.{wqkv|wo|up|down}": [K]
    f32} (calibration and the online predictor's warmup read it);
    "full" returns the raw inputs instead. Off (the default), the forward
    runs no reduction for it."""
    _check_supported(cfg)
    _check_attn_impl(specs.attn_impl)
    if params.stacked is not None:
        raise NotImplementedError("stacked (scan) params")
    B, T = tokens.shape
    verify = slot_lengths is not None and T > 1
    W, pattern = cfg.sliding_window, cfg.sliding_window_pattern
    head_major = cache.head_major
    if (head_major and W is not None and pattern != 1
            and cache.max_seq > W):
        # JAX's guard for a head-major cache (decoder.py:497-508): kernel 3
        # takes no per-layer window start, so the window must never bind
        raise NotImplementedError(
            "head-major (flash) KV cache: alternating-window (gemma2) "
            f"models need max_seq <= sliding_window ({cache.max_seq} > "
            f"{W}); create the cache with head_major=False for longer "
            "contexts")
    if head_major and T > 1 and not verify and cache.host_length != 0:
        raise NotImplementedError(
            "a prefill chunk on a head-major cache must start on a fresh "
            "cache (continuation chunks attend over the batch-major cache)")
    ring = writes_ring(cfg, cache)
    if (ring and T > 1 and not verify
            and cache.host_length + T > cache.max_seq
            and cache.max_seq < W + T):
        # JAX's guard (decoder.py:477-485): a chunk that straddles the wrap
        # would overwrite positions still inside an in-chunk query's
        # window. JAX must decide it statically; the host knows the length,
        # so only a chunk that does reach the wrap raises here
        raise ValueError(
            f"ring KV cache needs max_seq >= sliding_window + chunk "
            f"({cache.max_seq} < {W} + {T})")
    x = params.embed[tokens].to(specs.wqkv.odtype)
    if cfg.embed_multiplier != 1.0:
        # gemma: sqrt(hidden), rounded to the activation dtype first, as JAX
        # and HF multiply; made once per value and device
        x = x * constant(cfg.embed_multiplier, x.dtype, x.device)
    if slot_lengths is not None:
        # per-row positions (JAX's slot mode: kv_start does not shift RoPE)
        q_slot = (slot_lengths[:, None]
                  + torch.arange(T, device=tokens.device)[None])   # [B, T]
        rope_pos = q_slot
        kv_len = (slot_lengths + T).to(torch.int32)           # [B] int32
        slots = None
    else:
        # positions from the device length: a captured step replays at
        # each replay's length
        q_slot = cache.length + torch.arange(T, device=tokens.device)
        if kv_start is not None:
            rope_pos = torch.clamp_min(q_slot[None, :] - kv_start[:, None],
                                       0)
        else:
            rope_pos = q_slot
        kv_len = (cache.length + T).expand(B).contiguous()    # [B] int32
        slots = cache.slots(T, ring)
    if params.pos_embed is not None:
        # OPT's learned positions at the RoPE positions (per row in slot
        # mode), added in the activation dtype (decoder.py:457-459)
        pe = params.pos_embed[rope_pos].to(x.dtype)
        x = x + (pe[None] if rope_pos.dim() == 1 else pe)
    # ALiBi and learned-position models rotate nothing (apply_rope's style
    # "none"); partial rotary models take tables of their rotary dim
    cos, sin = (rope_cos_sin(rope_pos, cfg.rotary_dim or cfg.head_dim_,
                             cfg.rope_theta,
                             rope_scaling(cfg, cache.max_seq))
                if cfg.rope_style != "none" else (None, None))
    # gemma2's attention (None elsewhere)
    attn_scale = (cfg.query_pre_attn_scalar ** -0.5
                  if cfg.query_pre_attn_scalar is not None else None)
    attn_softcap = cfg.attn_logit_softcap
    # ALiBi's [n_q] slopes on the cache's device, as JAX passes them to
    # every attention (decoder.py:487-494; falcon's divided by
    # sqrt(head_dim))
    alibi = None
    if cfg.alibi:
        alibi = (falcon_alibi_slopes(cfg.num_attention_heads, cfg.head_dim_,
                                     cache.k.device)
                 if cfg.model_type == "falcon" else
                 alibi_slopes(cfg.num_attention_heads, cache.k.device))
    # layer windows: uniform, or on layers i % pattern == 0 (gemma2); the
    # decode step's first position for each distinct window
    windows = [W if W is not None and i % pattern == 0 else None
               for i in range(len(params.blocks))]
    starts = ({w: window_start(kv_start, kv_len, w) for w in set(windows)}
              if T == 1 else {})
    decode = (flash_decode_attention if head_major
              else functools.partial(decode_attention, ring=ring))
    all_stats = {}

    for i, bp in enumerate(params.blocks):
        win = windows[i]

        def kv_apply(q, k, v, i=i, win=win):
            if slot_lengths is not None:
                cache.update_layer_slots(i, k, v, slot_lengths, ring=ring)
            else:
                cache.update_layer(i, k, v, ring=ring, slots=slots)
            k_c, v_c, ks_c, vs_c = cache.layer_kv(i)
            if verify:
                return _verify_attend(q, k_c, v_c, ks_c, vs_c, q_slot,
                                      slot_lengths, kv_start, win,
                                      head_major, ring, attn_scale,
                                      attn_softcap, alibi)
            if T == 1:
                out = decode(q[:, 0], k_c, v_c, kv_len, ks_c, vs_c,
                             kv_start=starts[win],
                             softcap=attn_softcap or 0.0, scale=attn_scale,
                             alibi_slopes=alibi)
                return out[:, None]
            # a profiler range, so a trace reads prefill attention's
            # device time (chip_smoke.py's evaluation split)
            with torch.profiler.record_function(PREFILL_ATTEND):
                if head_major:
                    # fresh-cache prefill: attention over the chunk's own
                    # fp k/v equals attention over the cache
                    return attend(q, k, v, q_slot, kv_len,
                                  kv_start=kv_start, sliding_window=win,
                                  scale=attn_scale, softcap=attn_softcap,
                                  alibi=alibi)
                # JAX's batch-major prefill: attend over the cache layer
                return attend(q, k_c, v_c, q_slot, kv_len, kv_start=kv_start,
                              sliding_window=win, k_scale=ks_c, v_scale=vs_c,
                              scale=attn_scale, softcap=attn_softcap,
                              ring=ring, alibi=alibi)

        stats = {} if collect_stats else None
        x = block_core(x, bp, kv_apply, cos, sin, specs, cfg, stats)
        if collect_stats:
            for slot, a in stats.items():
                all_stats[f"{i}.{slot}"] = (a if collect_stats == "full"
                                            else Q.absmax_channels(a))
    if slot_lengths is None:
        cache.advance(T)
    logits = None if head_f32 is None else _head(x, params, specs, cfg,
                                                 head_f32)
    if collect_stats:
        return logits, cache, all_stats
    return logits, cache


def _verify_attend(q, k_c, v_c, ks_c, vs_c, q_slot, slot_lengths, kv_start,
                   win, head_major, ring, scale, softcap, alibi):
    """The speculative verify's attention over a pool layer that already
    holds all T verify tokens: on the batch-major cache `attend` with the
    [B, T] query positions at length slot_lengths + T (its causal mask
    gives query t its prefix); on the head-major cache kernel 3 once per
    query t at the per-row length slot_lengths + t + 1 and that length's
    window start."""
    T = q.shape[1]
    if not head_major:
        return attend(q, k_c, v_c, q_slot, slot_lengths + T,
                      kv_start=kv_start, sliding_window=win, k_scale=ks_c,
                      v_scale=vs_c, scale=scale, softcap=softcap, ring=ring,
                      alibi=alibi)
    outs = []
    for t in range(T):
        len_t = (slot_lengths + (t + 1)).to(torch.int32)
        outs.append(flash_decode_attention(
            q[:, t].contiguous(), k_c, v_c, len_t, ks_c, vs_c,
            kv_start=window_start(kv_start, len_t, win),
            softcap=softcap or 0.0, scale=scale, alibi_slopes=alibi))
    return torch.stack(outs, dim=1)


def _head(x, params: DecoderParams, specs: DecoderSpecs, cfg: ModelConfig,
          head_f32: torch.Tensor) -> torch.Tensor:
    """The final norm and the f32 head: logits [B, T, V] f32."""
    x = _norm(x, params.lnf_scale, params.lnf_bias, cfg)
    # jnp.dot(bf16, bf16, preferred_element_type=f32): f32 products of the
    # bf16-rounded operands, summed in f32
    logits = torch.matmul(x.to(specs.wqkv.odtype).float(), head_f32)
    if cfg.final_logit_softcap is not None:        # gemma2
        cap = cfg.final_logit_softcap
        logits = torch.tanh(true_div(logits, cap)) * cap
    return logits


# ---------------------------------------------------------------------------
# Random init (tests, smoke runs)
# ---------------------------------------------------------------------------

def init_decoder_params(
    cfg: ModelConfig,
    specs: Optional[DecoderSpecs] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    outlier_budget: int = 0,
) -> DecoderParams:
    """Random N(0, 0.02) weights, quantized at init slot by slot as `specs`
    says (e.g. resolve_specs(QuantConfig.w4a4()): q/k/v/up/gate W4A4, o/down
    W8A8).

    With `outlier_budget` > 0 every MIX or QUIK linear INPUT gets that many
    seeded fp outlier channels (through outlier_set_from_indices and
    from_float(outlier_set=...)): q/k/v share one set, as they share one
    activation, and so do up/gate; o and down have their own. FP16 and
    WEIGHT_ONLY linears get none. JAX's init makes no outlier sets, so this
    is the port's way to run the outlier term of the GEMM on random
    weights; likewise a model with `attention_bias` (qwen2, qwen2_moe) gets
    N(0, 0.02) q/k/v biases, one with `mlp_bias` (starcoder2) N(0, 0.02) up
    and down biases, and opt N(0, 0.02) learned positions. As JAX's init
    (decoder.py:886-941) makes them: a qk_norm model (qwen3) unit QK-norm
    scales, a LayerNorm model zero norm biases, a parallel block no second
    norm (ln2_scale None) and a non-gated MLP no gate; an MoE model
    (num_local_experts > 0) an N(0, 0.02) router [H, E] and stacked N(0,
    0.02) experts quantized per (expert, out-channel) by expert_from_float
    (gate as specs.gate, up, down), with no outlier sets and no shared
    expert (JAX's init, decoder.py:913-928)."""
    _check_supported(cfg)
    specs = specs or DecoderSpecs.fp16()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n_q, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim_)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype) * 0.02

    def oset(K: int, spec: LinearSpec):
        if not outlier_budget or spec.version not in ("MIX", "QUIK"):
            return None
        idx = torch.randperm(K, generator=generator, device=device)
        return Q.outlier_set_from_indices(
            torch.sort(idx[:outlier_budget]).values, K, outlier_budget,
            device=device)

    def ones(n):
        return torch.ones((n,), dtype=torch.float32, device=device)

    ln_bias = cfg.layernorm == "layernorm"

    def zeros(n, on=True):
        return (torch.zeros((n,), dtype=torch.float32, device=device)
                if on else None)

    def mlp_bias(n):
        return normal(n) if cfg.mlp_bias else None

    blocks = []
    for _ in range(cfg.num_hidden_layers):
        s_qkv, s_o = oset(H, specs.wqkv), oset(n_q * hd, specs.wo)
        s_up, s_down = oset(H, specs.up), oset(I, specs.down)
        wq, wk, wv = (normal(H, n * hd) for n in (n_q, n_kv, n_kv))
        bias = ((normal(n_q * hd), normal(n_kv * hd), normal(n_kv * hd))
                if cfg.attention_bias else (None,) * 3)
        attn = AttnParams(
            wq=from_float(wq, specs.wqkv, bias=bias[0], outlier_set=s_qkv),
            wk=from_float(wk, specs.wqkv, bias=bias[1], outlier_set=s_qkv),
            wv=from_float(wv, specs.wqkv, bias=bias[2], outlier_set=s_qkv),
            wo=from_float(normal(n_q * hd, H), specs.wo, outlier_set=s_o),
            q_norm=ones(hd) if cfg.qk_norm else None,
            k_norm=ones(hd) if cfg.qk_norm else None,
        )
        if cfg.num_local_experts > 0:
            E = cfg.num_local_experts

            def experts(d_in, d_out, spec):
                return expert_from_float(normal(E, d_in, d_out), spec)
            mlp = MLPParams(up=None, gate=None, down=None, moe=MoEParams(
                router=normal(H, E), gate=experts(H, I, specs.gate),
                up=experts(H, I, specs.up), down=experts(I, H, specs.down)))
        else:
            mlp = MLPParams(
                up=from_float(normal(H, I), specs.up, bias=mlp_bias(I),
                              outlier_set=s_up),
                gate=(from_float(normal(H, I), specs.gate, outlier_set=s_up)
                      if gated_mlp(cfg) else None),
                down=from_float(normal(I, H), specs.down, bias=mlp_bias(H),
                                outlier_set=s_down),
            )
        seq = not cfg.parallel_attn_mlp
        blocks.append(BlockParams(
            ln1_scale=ones(H), ln1_bias=zeros(H, ln_bias), attn=attn,
            ln2_scale=ones(H) if seq else None,
            ln2_bias=zeros(H, ln_bias and seq), mlp=mlp,
            post_attn_norm_scale=ones(H) if cfg.post_norms else None,
            post_ffw_norm_scale=ones(H) if cfg.post_norms else None))
    return DecoderParams(
        embed=normal(V, H),
        blocks=tuple(blocks),
        lnf_scale=ones(H),
        lnf_bias=zeros(H, ln_bias),
        lm_head=None if cfg.tie_word_embeddings else normal(H, V),
        pos_embed=(normal(cfg.max_position_embeddings, H)
                   if cfg.model_type == "opt" else None),
    )
