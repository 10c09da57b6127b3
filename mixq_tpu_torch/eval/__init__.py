"""Evaluation (mirrors mixq_tpu/eval/): perplexity, the lm-eval adaptor
with its offline tasks, and MMLU."""
from mixq_tpu_torch.eval.perplexity import PerplexityResult, compute_perplexity

__all__ = ["PerplexityResult", "compute_perplexity"]
