"""Configuration dataclasses for the PyTorch port.

Mirrors mixq_tpu/config.py field for field (a copy, so the port never
imports the JAX package): a config serialized by either package loads in
the other. Some EngineConfig fields describe JAX-side machinery (meshes,
tail windows and their flush) that the port does not run; they are kept
so that JSON round-trips unchanged. `device_decode_loop` drives the
port's device decode loops (engine.DecodeLoop and the continuous-batching
windows: a CUDA graph of the decode step on the card); `max_batch_size`,
`window_r` and `prefill_token_budget` size the continuous-batching pool,
its windows and its admission prefill; the spec_* fields and
`async_windows` drive its speculation and async windows, as in JAX.

Replaces the reference's scattered config surface (quant_config.json dict at
models/base.py:249-255, magic numbers in Cache.py:6-22, policy tables in
utils/module.py:2-12, env vars BATCH_SIZE/WORLD_SIZE) with one typed config.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization scheme config.

    Mirrors the reference's quant_config.json {"w_bit", "version",
    "q_group_size"} (models/base.py:249-255) plus the implicit constants:
    sigma=6 outlier threshold (Cache.py:9), outlier budget 128/256
    (models/base.py:303,387), warmup stop=2 (Cache.py:22).
    """

    w_bit: int = 8                     # weight bits: 4, 8, or 16 (fp16 = no quant)
    a_bit: int = 16                    # activation bits: 4, 8, or 16
    version: str = "MIX"               # "MIX" | "QUIK" | "WEIGHT_ONLY" | "FP16"
    q_group_size: int = -1             # -1 = per-channel (reference default)
    outlier_budget: int = 128          # max fp16 outlier channels per linear
    outlier_sigma: float = 6.0         # |x| threshold for online outlier detect
    warmup_steps: int = 2              # online-predictor warmup forwards before freeze
    # per-layer-name overrides: layers matching these suffixes are forced to
    # 8-bit even in 4-bit models (reference eightbit_only_name, utils/module.py:2)
    eightbit_only_names: Tuple[str, ...] = ("down_proj", "o_proj", "fc_out")
    # layers matching these suffixes use weight-only W8A16
    # (reference weight_only_map, utils/module.py:4-12)
    weight_only_names: Tuple[str, ...] = ()
    # compute/kv dtype
    dtype: str = "bfloat16"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "QuantConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: (tuple(v) if isinstance(v, list) else v) for k, v in d.items() if k in fields}
        return cls(**d)

    @classmethod
    def fp16(cls) -> "QuantConfig":
        return cls(w_bit=16, a_bit=16, version="FP16")

    @classmethod
    def w8a8(cls, **kw) -> "QuantConfig":
        return cls(w_bit=8, a_bit=8, version="MIX", **kw)

    @classmethod
    def w4a4(cls, **kw) -> "QuantConfig":
        kw.setdefault("outlier_budget", 128)
        return cls(w_bit=4, a_bit=4, version="MIX", **kw)

    @classmethod
    def quik_w4a4(cls, **kw) -> "QuantConfig":
        kw.setdefault("outlier_budget", 256)
        return cls(w_bit=4, a_bit=4, version="QUIK", **kw)

    @classmethod
    def w8a16(cls, **kw) -> "QuantConfig":
        return cls(w_bit=8, a_bit=16, version="WEIGHT_ONLY", **kw)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture config for the functional decoder models.

    Superset of the fields the reference pulls from HF configs
    (modules/fused/attn.py:77-114, models/llama.py:24-71).
    """

    model_type: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32      # < num_attention_heads => GQA/MQA
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"           # "silu" | "gelu" | "gelu_new"
    attention_bias: bool = False       # qwen2: True for qkv
    mlp_bias: bool = False
    layernorm: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    parallel_attn_mlp: bool = False    # falcon/gptj-style parallel block
    rope_style: str = "neox"           # "neox" (half-rotate) | "gptj" (interleaved)
    rotary_dim: Optional[int] = None   # partial rotary (gptj/chatglm)
    qk_norm: bool = False              # per-head RMSNorm on q/k before RoPE
                                       # (qwen3)
    # gemma2 block/attention quirks
    post_norms: bool = False           # extra norms on attn/mlp OUTPUTS
                                       # before the residual adds
    query_pre_attn_scalar: Optional[float] = None  # score scale =
                                       # this^-0.5 instead of head_dim^-0.5
    attn_logit_softcap: Optional[float] = None     # tanh softcap on scores
    final_logit_softcap: Optional[float] = None    # tanh softcap on logits
    sliding_window_pattern: int = 1    # window applies to layers with
                                       # i % pattern == 0 (gemma2: 2 —
                                       # alternating local/global)
    # sparse mixture-of-experts (mixtral family): >0 experts makes every
    # block's MLP a routed top-k MoE (ops/moe.py)
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    moe_norm_topk: bool = True         # renormalize top-k router weights
                                       # (mixtral yes, qwen2-moe no)
    moe_capacity_factor: float = 0.0   # <=0: exact (no token drops) —
                                       # correctness-first: every expert
                                       # allocates S slots, costing E x
                                       # dense-MLP FLOPs at prefill.
                                       # Serving configs should set ~1.25-2
                                       # (top-k-proportional slots, skewed
                                       # routing drops tokens — the
                                       # standard MoE serving trade)
    embed_multiplier: float = 1.0      # gemma scales embeddings by
                                       # sqrt(hidden_size) (rounded to the
                                       # activation dtype, matching HF)
    gated_mlp: Optional[bool] = None   # None: gated iff hidden_act=="silu"
                                       # (llama SwiGLU vs falcon/gptj plain);
                                       # gemma overrides True (GeGLU)
    # HF rope_scaling: "linear" (positions / factor) or "llama3"
    # (Llama-3.1+ piecewise frequency rescale). None = unscaled.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0      # llama3 only
    rope_high_freq_factor: float = 4.0     # llama3 only
    rope_original_max_position: int = 8192  # llama3 + longrope
    # longrope (phi3): per-frequency rescale factors; the serving context
    # (cache max_seq) statically picks short vs long, and cos/sin scale by
    # the attention factor
    rope_short_factor: Optional[Tuple[float, ...]] = None
    rope_long_factor: Optional[Tuple[float, ...]] = None
    rope_attention_factor: float = 1.0
    sliding_window: Optional[int] = None
    alibi: bool = False                # ALiBi additive attention bias instead
                                       # of rotary (Baichuan-13B, falcon-alibi;
                                       # reference QuantAttentionFusedBaichuan13B,
                                       # modules/fused/attn.py:283-470). Implies
                                       # rope_style "none".

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        # lists -> tuples: the config is a jit static and must stay hashable
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in fields})

    @classmethod
    def tiny(cls, **kw) -> "ModelConfig":
        """Small config for tests."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128,
        )
        base.update(kw)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Serving-engine config (batching, KV cache, mesh)."""

    max_batch_size: int = 8
    max_seq_len: int = 2048            # static KV allocation (reference default
                                       # max_new_tokens=2048, models/base.py:263)
    prefill_chunk: int = 512           # prefill bucketing granularity
    # cap on tokens (rows x chunk width) per batched-prefill dispatch in the
    # CB pool: bigger admission groups prefill as BOUNDED-T continuation
    # chunks into the same small cache, so prefill temporaries stop scaling
    # with slots x max_seq (the slots=64 7B compile-OOM: 17.7G > 15.75G of
    # remat temps, VERDICT r3 item 2 / PROFILE_r03 §11). 0 disables chunking.
    prefill_token_budget: int = 8192
    kv_dtype: str = "bfloat16"
    # mesh axes: data-parallel over DCN, tensor-parallel over ICI
    mesh_shape: Tuple[int, ...] = (1, 1)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    donate_kv: bool = True
    # sequence-parallel (ring-attention) prefill: fresh-cache prefills with
    # T >= ring_prefill_min_t shard the sequence over `ring_prefill_axis`
    # (context parallelism — the 'data' axis carries sequence during prefill,
    # batch during decode) while heads stay TP-sharded over 'model'
    ring_prefill_axis: Optional[str] = None
    ring_prefill_min_t: int = 1024
    # multi-token decode on the device (JAX: ONE lax.while_loop program;
    # the port: replays of a CUDA graph of the decode step): sampling + EOS
    # check on device, early exit when every row hit EOS — no host
    # round-trip per token (the stepwise path fetches sampled tokens every
    # step)
    device_decode_loop: bool = True
    # CB decode-window length (steps per step_window dispatch). 0 = the
    # flash tail default (DEFAULT_TAIL_R=8). For head-major caches this is
    # also the staged-tail size, so it shapes the flash kernel's tail
    # attend — bigger R amortizes per-window host/transport overhead at
    # the cost of more discarded post-finish tokens per slot.
    window_r: int = 0
    # lag-1 pipelined windows (step_window_async): dispatch window N+1
    # from DEVICE-carried (cur_tokens, lengths) before fetching window
    # N's outputs, so the fetch round-trip + host bookkeeping overlap
    # window N+1's device execution. Costs one window of admission lag
    # per request (completions are observed one window late).
    async_windows: bool = False
    # continuous-batching speculative decoding (prompt-lookup n-gram
    # drafts, engine/speculative.py): spec_k > 1 makes every CB decode
    # step a T=spec_k verify forward — greedy rows draft from their own
    # history and accept the matching prefix (bit-identical to plain
    # greedy), sampled rows ride along emitting one token. Works on
    # batch-major caches (direct span scatter) AND on the head-major
    # flash per-row-tail pools (verify tokens stage in the tail window
    # and the kernel's tail attend covers them); no sliding window.
    spec_k: int = 0
    spec_ngram: int = 3
    # device spec window: with device_decode_loop, chain spec_window_r
    # draft+verify+accept rounds in ONE dispatch (drafting runs ON DEVICE,
    # speculative.propose_ngram_device) — the host-loop spec path pays a
    # relay round-trip per verify forward
    spec_window_r: int = 8
    # adaptive speculation: a T=spec_k verify forward costs more than a
    # T=1 decode, so speculation LOSES when drafts rarely survive (gain =
    # emitted / (R * active_rows) per window; 1.0 = plain decode's rate).
    # When the rolling gain over spec_probe_len windows falls below
    # spec_min_gain, the engine serves PLAIN windows and re-probes with
    # spec windows every spec_probe_every plain windows (slot histories
    # are resynced from the host records on each probe).
    # spec_min_gain=None derives the threshold from spec_k as
    # 0.55 * (spec_k + 1): the r5 acceptance-cost curve measured a T=4
    # verify forward at ~2.7x a plain step in wall-clock (7B, 32 slots —
    # spec wins +14% at gain 3.04, loses -22% at gain 2.2, crossover
    # ~2.75; SERVE_SPEC_R05.jsonl). The old flat 1.15 default kept the
    # router in spec windows through the whole losing region.
    spec_adaptive: bool = True
    spec_min_gain: Optional[float] = None
    spec_probe_len: int = 2
    spec_probe_every: int = 16
    # MEASUREMENT INSTRUMENT (acceptance-cost curve, PROFILE_r05): corrupt
    # each drafted token with this probability inside the device spec
    # window, so per-token acceptance is ~(1 - noise) regardless of
    # substrate. A corrupted draft token still rides the verify forward
    # and stages KV — exactly the cost a real mis-draft pays — and the
    # model's own argmax rejects it. 0.0 (default) = off; output is then
    # bit-identical to plain greedy as always. With noise > 0 the tokens
    # EMITTED are still the model's own argmax continuations (correctness
    # preserved); only draft agreement — and therefore speculation's
    # speed — changes.
    spec_draft_noise: float = 0.0
    # fold the end-of-window tail flush into the window program (one
    # dispatch) vs run it as the separately-jitted _flush program after
    # the window returns. Folding creates a layout conflict inside the
    # combined program: the flush scatter wants a transposed cache
    # operand while the flash custom call needs the default layout, and
    # XLA materializes a WHOLE-CACHE relayout copy (3.0G cache_v temp at
    # 192 slots x 128 — the r5 capacity-OOM, campaign_r05a.log).
    # Unfolded, the donated-param aliasing of jit(_flush) pins default
    # layouts and the scatter transposes the small tail updates instead.
    # The extra dispatch carries no fetch, so under async windows it
    # pipelines into the stream.
    fold_flush: bool = True
    # pipeline-parallel serving: >1 routes every engine forward through
    # parallel/pipeline.py::pipeline_forward over a 'pipe' mesh axis
    # (stage-stacked params, GPipe microbatching, batch-major cache).
    # Scope mirrors pipeline_forward's: uniform dense specs, bf16/int8
    # KV, no sliding-window/ALiBi, no speculation, attn_impl resolves
    # batch-major (the PP serving story — VERDICT r4 item 7; TP+DP stay
    # the first-choice strategy, PARITY.md).
    pipe_stages: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def save_quant_config(cfg: QuantConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)


def load_quant_config(path: str) -> QuantConfig:
    with open(path) as f:
        return QuantConfig.from_dict(json.load(f))
