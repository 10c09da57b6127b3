"""Calibration data (mirrors mixq_tpu/utils/calib_data.py): a token stream
cut into fixed-length blocks, from a pre-tokenized .npy, a text file and
the caller's tokenizer, or synthetic tokens from a seed. Nothing is
downloaded; text is tokenized only by the tokenizer the caller passes."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


def blocks_from_tokens(token_ids, n_samples: int = 64,
                       block_len: int = 512) -> List[np.ndarray]:
    """Cut a token stream into [1, block_len] int32 calibration batches."""
    token_ids = np.asarray(token_ids, np.int32).reshape(-1)
    n = min(n_samples, len(token_ids) // block_len)
    if n == 0:
        raise ValueError(
            f"need >= {block_len} tokens for calibration, got {len(token_ids)}")
    return [token_ids[i * block_len:(i + 1) * block_len][None, :]
            for i in range(n)]


def get_calib_dataset(
    text_path: Optional[str] = None,
    tokenizer=None,
    tokens_path: Optional[str] = None,
    n_samples: int = 64,
    block_len: int = 512,
    vocab_size: Optional[int] = None,
    seed: int = 0,
) -> List[np.ndarray]:
    """Calibration batches from (in priority order): a pre-tokenized .npy,
    a text file + tokenizer, or synthetic random tokens."""
    if tokens_path:
        return blocks_from_tokens(np.load(tokens_path), n_samples, block_len)
    if text_path:
        if tokenizer is None:
            raise ValueError("text calibration needs a tokenizer")
        with open(text_path, errors="ignore") as f:
            text = f.read()
        ids = np.asarray(tokenizer(text).input_ids, np.int32)
        return blocks_from_tokens(ids, n_samples, block_len)
    if vocab_size is None:
        raise ValueError("synthetic calibration needs vocab_size")
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab_size, (1, block_len)).astype(np.int32)
            for _ in range(n_samples)]


def load_tokenizer(path: str):
    """transformers' tokenizer of a model directory: the one place the
    port imports transformers, and only for text the caller passes."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise ImportError(
            f"text needs transformers' tokenizer, which is not installed "
            f"({e}); pass token ids instead") from e
    return AutoTokenizer.from_pretrained(path)
