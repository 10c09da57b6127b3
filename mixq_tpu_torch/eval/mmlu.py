"""MMLU evaluation harness (mirrors mixq_tpu/eval/mmlu.py).

Hendrycks-format data: <data_dir>/{dev,test}/<subject>_{dev,test}.csv with
rows [question, A, B, C, D, answer]. Few-shot prompts are built as the
reference builds them; a question is scored by the logits at its prompt's
last position, argmax over the four answer-letter tokens, with the prompts
of a batch left-padded and their padding masked by `kv_start`.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.eval.perplexity import kv_torch_dtype
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache

CHOICES = ["A", "B", "C", "D"]
BATCH = 8                     # questions a forward, as JAX scores them


def _format_subject(subject: str) -> str:
    return subject.replace("_", " ")


def format_example(row: Sequence[str], include_answer: bool = True) -> str:
    """One question block."""
    prompt = row[0]
    for j, ch in enumerate(CHOICES):
        prompt += f"\n{ch}. {row[j + 1]}"
    prompt += "\nAnswer:"
    if include_answer:
        prompt += f" {row[5]}\n\n"
    return prompt


def gen_prompt(dev_rows: List[Sequence[str]], subject: str, k: int) -> str:
    """The few-shot header with k answered dev questions."""
    p = (f"The following are multiple choice questions (with answers) about "
         f"{_format_subject(subject)}.\n\n")
    for row in dev_rows[:k]:
        p += format_example(row, include_answer=True)
    return p


def _read_csv(path: str) -> List[List[str]]:
    with open(path, newline="", encoding="utf-8") as f:
        return [row for row in csv.reader(f)]


@dataclasses.dataclass
class MMLUResult:
    accuracy: float
    per_subject: Dict[str, float]
    n_questions: int


@torch.inference_mode()
def evaluate_mmlu(
    params: DecoderParams,
    cfg: ModelConfig,
    specs: DecoderSpecs,
    tokenizer,
    data_dir: str,
    n_shot: int = 5,
    max_subjects: Optional[int] = None,
    max_questions_per_subject: Optional[int] = None,
    max_seq: int = 2048,
    kv_dtype=torch.bfloat16,
) -> MMLUResult:
    """Accuracy over the subjects' test questions, on the params' device.
    A prompt over max_seq - 8 tokens drops shots until it fits, then is cut
    from the left."""
    test_dir = os.path.join(data_dir, "test")
    dev_dir = os.path.join(data_dir, "dev")
    subjects = sorted(
        f[: -len("_test.csv")] for f in os.listdir(test_dir)
        if f.endswith("_test.csv"))
    if max_subjects:
        subjects = subjects[:max_subjects]
    device = params.embed.device
    head = lm_head_f32(params, specs)

    # token ids of " A" ... " D" (last token)
    choice_ids = torch.tensor(
        [tokenizer(f" {c}", add_special_tokens=False).input_ids[-1]
         for c in CHOICES], dtype=torch.long, device=device)

    def score_batch(prompt_ids: List[List[int]]) -> np.ndarray:
        B = len(prompt_ids)
        Tp = max(len(p) for p in prompt_ids)
        toks = np.zeros((B, Tp), np.int32)
        start = np.zeros((B,), np.int32)
        for i, p in enumerate(prompt_ids):
            toks[i, Tp - len(p):] = p
            start[i] = Tp - len(p)
        cache = KVCache.create(cfg.num_hidden_layers, B, Tp,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               kv_torch_dtype(kv_dtype), device=device)
        logits, _ = forward(params, torch.from_numpy(toks).to(device), cache,
                            specs, cfg, torch.from_numpy(start).to(device),
                            head_f32=head)
        last = logits[:, -1, :]
        return torch.argmax(last[:, choice_ids], dim=-1).cpu().numpy()

    per_subject: Dict[str, float] = {}
    total_correct, total_n = 0, 0
    for subject in subjects:
        dev_rows = _read_csv(os.path.join(dev_dir, f"{subject}_dev.csv"))
        test_rows = _read_csv(os.path.join(test_dir, f"{subject}_test.csv"))
        if max_questions_per_subject:
            test_rows = test_rows[:max_questions_per_subject]

        header = gen_prompt(dev_rows, subject, n_shot)
        prompt_ids, answers = [], []
        for row in test_rows:
            text = header + format_example(row, include_answer=False)
            ids = tokenizer(text).input_ids
            k = n_shot
            while len(ids) > max_seq - 8 and k > 0:
                k -= 1
                ids = tokenizer(
                    gen_prompt(dev_rows, subject, k)
                    + format_example(row, include_answer=False)).input_ids
            prompt_ids.append(ids[-(max_seq - 8):])
            answers.append(CHOICES.index(row[5].strip()))

        correct = 0
        for i in range(0, len(prompt_ids), BATCH):
            picks = score_batch(prompt_ids[i:i + BATCH])
            correct += int(np.sum(picks == np.asarray(answers[i:i + BATCH])))
        per_subject[subject] = correct / max(len(test_rows), 1)
        total_correct += correct
        total_n += len(test_rows)

    return MMLUResult(
        accuracy=total_correct / max(total_n, 1),
        per_subject=per_subject,
        n_questions=total_n,
    )
