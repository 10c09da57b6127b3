"""Sparse mixture-of-experts MLP (mirrors mixq_tpu/ops/moe.py): the
Mixtral family and qwen2-moe's shared expert.

Experts live as stacked tensors [E, K, N], so each expert linear is one
batched product over every expert: under W8A8 kernel 2's expert mode
(kernels/mix_gemm.py::mix_gemm_experts, one launch for all E experts), under
WEIGHT_ONLY and FP16 a batched bf16 product in torch ops, as JAX's jnp one.
Expert weights are int8 per (expert, out-channel) whatever the spec's
w_bit (bf16 under FP16); activations quantize per (expert, slot) row; no
outlier set is applied per expert (JAX's design: the router already
filters by magnitude, and a per-expert budget would multiply the padded fp
products by E).

Routing is JAX's static-capacity index dispatch: every shape is fixed by
(B, T) and the capacity, never by the routing, and nothing is read on the
host, so a decode step with MoE blocks captures in a CUDA graph.
capacity_factor <= 0 (the default) gives C = S slots per expert: exact, no
token is dropped, and every expert computes S rows, most of them zero
sentinels. A positive factor bounds C = ceil(S / E * k * factor) and drops
(zero contribution) the choices past it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mixq_tpu_torch.kernels._build import apply_epilogue
from mixq_tpu_torch.kernels.mix_gemm import mix_gemm_experts
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                             mixed_linear,
                                             mixed_linear_prepared,
                                             prepare_act)
from mixq_tpu_torch.utils.arith import true_div


class ExpertLinearParams(NamedTuple):
    """Stacked per-expert linear: q_weight [E, K, N] (int8, or bf16 for
    FP16 specs), w_scale [E, N] f32 (None for FP16)."""

    q_weight: torch.Tensor
    w_scale: Optional[torch.Tensor]


class MoEParams(NamedTuple):
    router: torch.Tensor            # [H, E] fp router weights
    gate: ExpertLinearParams        # [E, H, I] (mixtral w1)
    up: ExpertLinearParams          # [E, H, I] (mixtral w3)
    down: ExpertLinearParams        # [E, I, H] (mixtral w2)
    # qwen2-moe's shared expert: a dense SwiGLU every token passes through,
    # its output scaled by sigmoid(x @ shared_route)
    shared_gate: Optional[MixLinearParams] = None   # [H, I_sh]
    shared_up: Optional[MixLinearParams] = None
    shared_down: Optional[MixLinearParams] = None
    shared_route: Optional[torch.Tensor] = None     # [H, 1] fp


def expert_from_float(w_ekn: torch.Tensor, spec: LinearSpec,
                      store_dtype: torch.dtype = torch.bfloat16
                      ) -> ExpertLinearParams:
    """Quantize stacked expert weights [E, K, N] per (expert, out-channel):
    int8 for MIX, QUIK and WEIGHT_ONLY specs, a store_dtype copy for FP16
    (JAX's expert_from_float, bit for bit)."""
    if spec.version == "FP16":
        return ExpertLinearParams(w_ekn.to(store_dtype), None)
    w = w_ekn.float()
    scale = torch.clamp_min(true_div(w.abs().amax(dim=1), 127.0), 1e-8)
    q = torch.clamp(torch.round(w / scale[:, None, :]), -127, 127)
    return ExpertLinearParams(q.to(torch.int8), scale)


def expert_linear(p: ExpertLinearParams, x_eck: torch.Tensor,
                  spec: LinearSpec) -> torch.Tensor:
    """[E, C, K] x [E, K, N] -> [E, C, N] f32.

    W8A8 (any spec with int8 weights and a_bit <= 8): the activations
    quantize per (expert, slot) row at 8 bits, then kernel 2's expert mode,
    acc * x_scale * w_scale. WEIGHT_ONLY or a_bit > 8: the int8 weight
    times its scale in bf16, then a bf16 product. FP16: a bf16 product. The
    bf16 products sum the exact f32 products of their operands in f32, as
    XLA's dot with preferred_element_type=f32."""
    if p.w_scale is None:                                    # FP16
        return torch.bmm(x_eck.to(p.q_weight.dtype).float(),
                         p.q_weight.float())
    if spec.version == "WEIGHT_ONLY" or spec.a_bit > 8:
        w = (p.q_weight.to(torch.bfloat16)
             * p.w_scale[:, None, :].to(torch.bfloat16))
        return torch.bmm(x_eck.to(torch.bfloat16).float(), w.float())
    xq, xs = Q.quantize_act_per_token(x_eck)                 # [E,C,K],[E,C,1]
    return mix_gemm_experts(xq, p.q_weight, xs, p.w_scale)


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 factor: float) -> int:
    """Per-expert slot count. factor <= 0 -> exact (C = n_tokens)."""
    if factor <= 0:
        return n_tokens
    return min(n_tokens,
               max(top_k, math.ceil(n_tokens * top_k / n_experts * factor)))


def _act(g: torch.Tensor, act: str) -> torch.Tensor:
    """jax.nn.silu, or jax.nn.gelu(approximate=True), on f32 g."""
    return apply_epilogue(g, "silu" if act == "silu" else "gelu_new")


def moe_mlp(x: torch.Tensor, p: MoEParams, spec_up: LinearSpec,
            spec_down: LinearSpec, top_k: int,
            capacity_factor: float = 0.0, act: str = "silu",
            norm_topk: bool = True) -> torch.Tensor:
    """Sparse-MoE gated MLP over [B, T, H] in HF's semantics (Mixtral's
    sparse block: f32 router logits, a softmax over all experts, the top k,
    renormalised when norm_topk; qwen2-moe keeps the raw weights). The top
    k take ties by the lower expert first, as jax.lax.top_k
    (ops/quant.py::top_indices). A qwen2-moe shared expert (a dense SwiGLU
    gated by sigmoid(x @ shared_route)) adds in at the end."""
    B, T, H = x.shape
    S = B * T
    E = p.router.shape[1]
    dev = x.device
    xs = x.reshape(S, H)

    logits = xs.float() @ p.router.float()                   # [S, E]
    probs = torch.softmax(logits, dim=-1)
    top_e = Q.top_indices(probs, top_k)                      # [S, k]
    top_w = torch.gather(probs, 1, top_e)
    if norm_topk:
        top_w = top_w / top_w.sum(dim=-1, keepdim=True)

    # each (token, choice) claims the next free slot of its expert: its
    # position counts the earlier tokens' choices of that expert and this
    # token's earlier choices; slots >= C drop
    C = moe_capacity(S, E, top_k, capacity_factor)
    sel = (top_e[..., None] == torch.arange(E, device=dev)).long()  # [S,k,E]
    per_token = sel.sum(dim=1)                               # [S, E]
    earlier_tokens = torch.cumsum(per_token, dim=0) - per_token
    earlier_choices = torch.cumsum(sel, dim=1) - sel
    pos = ((earlier_tokens[:, None, :] + earlier_choices) * sel).sum(dim=2)
    valid = pos < C                                          # [S, k]

    # tok_of[e, c]: the token in expert e's slot c. Slots are unique per
    # expert; dropped choices all write the sentinel row and column E, C
    # (sliced off), and unused slots keep token S, the zero row
    tok_of = torch.full((E + 1, C + 1), S, dtype=torch.long, device=dev)
    tok_src = torch.arange(S, device=dev)[:, None].expand(S, top_k)
    tok_of[torch.where(valid, top_e, E), torch.where(valid, pos, C)] = tok_src
    xe = torch.cat([xs, xs.new_zeros(1, H)])[tok_of[:E, :C]]  # [E, C, H]

    g = expert_linear(p.gate, xe, spec_up)                   # [E, C, I] f32
    u = expert_linear(p.up, xe, spec_up)
    inner = _act(g, act) * u
    y = expert_linear(p.down, inner.to(x.dtype), spec_down)  # [E, C, H]

    # each (token, choice)'s result gathered back and weighted
    y_sk = y[torch.where(valid, top_e, 0), torch.where(valid, pos, 0)]
    w_sk = torch.where(valid, top_w, 0.0)[..., None]
    out = (w_sk * y_sk).sum(dim=1)                           # [S, H] f32

    if p.shared_up is not None:
        # gate and up share ONE quantized activation on a MIX path
        if spec_up.version in ("FP16", "WEIGHT_ONLY", "QUIK"):
            sg = mixed_linear(p.shared_gate, x, spec_up).float()
            su = mixed_linear(p.shared_up, x, spec_up).float()
        else:
            qact = prepare_act(x, p.shared_up, spec_up)
            sg = mixed_linear_prepared(p.shared_gate, qact, spec_up).float()
            su = mixed_linear_prepared(p.shared_up, qact, spec_up).float()
        sh = mixed_linear(p.shared_down, (_act(sg, act) * su).to(x.dtype),
                          spec_down).float()
        route = torch.sigmoid(xs.float() @ p.shared_route.float())
        out = out + route * sh.reshape(S, H)
    return out.reshape(B, T, H).to(x.dtype)
