"""Token sampling (mirrors mixq_tpu/engine/sampling.py): greedy, temperature,
top-k and top-p. A sampled token is drawn as jax.random.categorical draws
it, by the Gumbel-max rule, from uniforms of an explicit torch.Generator:
the same function of other random bits, so a sampled token stream differs
from JAX's at the same seed; greedy decoding is deterministic on both
sides. Nothing here reads the device on the host, so a CUDA graph of the
decode step holds the sampling too (the generator registered with the
graph); torch.multinomial would check its input on the host."""
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
    # Gumbel-max: argmax(logits - log(-log u)), u uniform in [tiny, 1)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min_(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def chosen_logprob(logits: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen tokens under the raw distribution:
    logits [B, V], tok [B] -> [B] f32."""
    return torch.gather(torch.log_softmax(logits.float(), dim=-1), 1,
                        tok.long()[:, None])[:, 0]
