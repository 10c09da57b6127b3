"""Token sampling (mirrors mixq_tpu/engine/sampling.py): greedy, temperature,
top-k and top-p. A sampled token is drawn as jax.random.categorical draws
it, by the Gumbel-max rule, from uniforms of an explicit torch.Generator:
the same function of other random bits, so a sampled token stream differs
from JAX's at the same seed; greedy decoding is deterministic on both
sides. Nothing here reads the device on the host, so a CUDA graph of the
decode step holds the sampling too (the generator registered with the
graph); torch.multinomial would check its input on the host.

`sample_per_slot` is the continuous-batching sampler: per-row temperature,
top-k and top-p, JAX's `sample_per_slot`. JAX skips its sort for an
all-greedy batch with a lax.cond on the device; here the caller, which
knows every slot's parameters on the host, says whether any row samples
(`sampled`), so no host read of the device decides it."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mixq_tpu_torch.utils.arith import true_div


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0       # 0 = greedy
    top_k: int = 0                 # 0 = disabled
    top_p: float = 1.0             # 1 = disabled


def sample(
    logits: torch.Tensor,          # [B, V] f32
    generator: Optional[torch.Generator],
    params: SamplingParams,
) -> torch.Tensor:
    """Sample next tokens [B] int32."""
    if params.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)

    logits = true_div(logits, params.temperature)
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < params.top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return _gumbel_argmax(logits, generator)


def _gumbel_argmax(logits: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gumbel-max: argmax(logits - log(-log u)), u uniform in [tiny, 1)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample_per_slot(
    logits: torch.Tensor,          # [B, V] f32
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,     # [B] f32; <= 0: greedy for that row
    top_k: torch.Tensor,           # [B] int; 0: disabled
    top_p: torch.Tensor,           # [B] f32; 1: disabled
    sampled: bool = True,
) -> torch.Tensor:
    """Next tokens [B] int32 with per-row sampling parameters (JAX's
    sample_per_slot, mixq_tpu/engine/sampling.py:58-102). Greedy rows take
    the argmax of the raw logits. Sampling rows divide by their
    temperature, keep exactly k entries by rank (ties by the lower index,
    as JAX's stable argsort orders them: ops/quant.py::top_indices' rule),
    then the smallest prefix of the sorted, k-masked probabilities that
    reaches top_p, and draw by Gumbel-max from `generator`.

    `sampled=False` says that no row samples (every temperature <= 0): the
    step is the argmax alone and draws nothing. The caller decides it on
    the host from the slots' parameters."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    B, V = logits.shape
    t = torch.clamp_min(temperature, 1e-6)[:, None]
    lg = logits / t
    # rank of each entry in a stable descending sort (JAX: argsort(-l))
    order = torch.sort(lg, dim=-1, descending=True, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(V, device=lg.device).expand(B, V))
    k_eff = torch.where(top_k > 0, top_k.long(), V)[:, None]
    lg = torch.where(ranks < k_eff, lg, float("-inf"))
    sl = torch.sort(lg, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sl, dim=-1), dim=-1)
    # past the end (cum < top_p everywhere, as at top_p = 1) the cutoff is
    # the smallest entry, which masks nothing, as JAX's gather gives
    cutoff_idx = torch.sum(cum < top_p[:, None], dim=-1, keepdim=True)
    cutoff = torch.gather(sl, -1, cutoff_idx.clamp_max(V - 1))
    lg = torch.where(lg < cutoff, float("-inf"), lg)
    return torch.where(temperature <= 0, greedy,
                       _gumbel_argmax(lg, generator))


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen tokens under the raw distribution:
    logits [B, V], tok [B] -> [B] f32."""
    return torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                        tok.long()[:, None])[:, 0]
