"""Offline lm-eval-style tasks (mirrors mixq_tpu/eval/offline_tasks.py).

A minimal workalike of EleutherAI lm-eval's request protocol: requests are
`Instance(args=...)` objects handed to an adaptor's batched
`loglikelihood` / `generate_until` (eval/lm_eval_adaptor.py::MixQLM), as
lm_eval.simple_evaluate hands them, with two tasks built from a token
stream:

  cloze       pick the true continuation of a context among distractors by
              summed continuation logprob (the loglikelihood path);
  completion  greedy generation scored by exact match against the true
              continuation (the generate_until path).

Texts are space-separated token ids; `IntTokenizer` maps them 1:1, so any
model over a token vocabulary is a valid subject. On the Markov substrate
(utils/substrate.py::make_markov_state) the true continuation is
deterministic, so a correct adaptor scores ~1.0. This module is numpy and
protocol code, a copy of JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["Instance", "IntTokenizer", "build_cloze_task",
           "build_completion_task", "evaluate_cloze", "evaluate_completion"]


@dataclasses.dataclass
class Instance:
    """Duck-typed lm_eval.api.instance.Instance: the adaptor only reads
    `.args` — exactly what the real harness hands it."""

    request_type: str
    args: tuple


class IntTokenizer:
    """Tokenizer over space-separated integer-id text (1:1, reversible)."""

    bos_token_id = 1
    eos_token_id = 0

    def __call__(self, text, add_special_tokens: bool = True):
        ids = [int(t) for t in text.split()] if text and text.strip() else []
        if add_special_tokens:
            ids = [self.bos_token_id] + ids

        class R:
            pass

        r = R()
        r.input_ids = ids
        return r

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def _text(ids: Sequence[int]) -> str:
    return " ".join(str(int(i)) for i in ids)


def build_cloze_task(
    corpus: np.ndarray,
    n_items: int = 32,
    ctx_len: int = 16,
    cont_len: int = 4,
    n_choices: int = 4,
    seed: int = 0,
) -> List[Tuple[str, List[str], int]]:
    """Multiple-choice cloze items from a token stream: context = a window
    of the stream, true continuation = the next `cont_len` tokens,
    distractors = continuations lifted from elsewhere in the stream.
    Returns [(ctx_text, [choice_texts], true_idx)]."""
    rng = np.random.RandomState(seed)
    items = []
    hi = len(corpus) - (ctx_len + cont_len) - 1
    for _ in range(n_items):
        at = rng.randint(0, hi)
        ctx = corpus[at:at + ctx_len]
        true = corpus[at + ctx_len:at + ctx_len + cont_len]
        choices = [true]
        while len(choices) < n_choices:
            j = rng.randint(0, hi)
            d = corpus[j:j + cont_len]
            if not np.array_equal(d, true):
                choices.append(d)
        order = rng.permutation(n_choices)
        true_idx = int(np.where(order == 0)[0][0])
        items.append((_text(ctx), [_text(choices[o]) for o in order],
                      true_idx))
    return items


def build_completion_task(
    corpus: np.ndarray,
    n_items: int = 16,
    ctx_len: int = 16,
    gen_len: int = 4,
    seed: int = 1,
) -> List[Tuple[str, str]]:
    """Greedy-completion items: [(ctx_text, true_continuation_text)]."""
    rng = np.random.RandomState(seed)
    hi = len(corpus) - (ctx_len + gen_len) - 1
    return [
        (lambda at: (_text(corpus[at:at + ctx_len]),
                     _text(corpus[at + ctx_len:at + ctx_len + gen_len])))(
            rng.randint(0, hi))
        for _ in range(n_items)
    ]


def evaluate_cloze(lm, items) -> dict:
    """Drive lm.loglikelihood with the harness's request protocol: one
    (context, continuation) Instance per choice, batched through the
    adaptor, answer = argmax summed continuation logprob."""
    reqs = [Instance("loglikelihood", (ctx, " " + ch))
            for ctx, chs, _ in items for ch in chs]
    res = lm.loglikelihood(reqs)
    n_choices = len(items[0][1])
    correct = 0
    for i, (_, _, true_idx) in enumerate(items):
        lps = [res[i * n_choices + j][0] for j in range(n_choices)]
        correct += int(np.argmax(lps)) == true_idx
    return {"task": "synth_cloze", "metric": "acc",
            "acc": correct / len(items), "n": len(items),
            "chance": 1.0 / n_choices}


def evaluate_completion(lm, items) -> dict:
    """Drive lm.generate_until: greedy generation, exact-match scoring."""
    gen_len = len(items[0][1].split())
    reqs = [Instance("generate_until",
                     (ctx, {"max_gen_toks": gen_len, "until": []}))
            for ctx, _ in items]
    outs = lm.generate_until(reqs)
    correct = sum(
        out.split()[:gen_len] == target.split()
        for out, (_, target) in zip(outs, items))
    return {"task": "synth_completion", "metric": "exact_match",
            "exact_match": correct / len(items), "n": len(items)}
