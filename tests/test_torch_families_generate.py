"""PyTorch port, the RMSNorm families of tests/test_torch_families.py
(qwen2 at g = 7, qwen3's QK-norm, phi3 at head dim 96 and with partial
rotary and longrope, gemma, llama with llama3 rope scaling) on the CPU:
the greedy tokens of `generate` (W8A8O16 with planted outlier sets) equal
JAX's InferenceEngine's, under "auto" with bf16 KV (batch-major: kernel 8's
plain version) and under "flash" with int8 KV (head-major: kernel 3's),
each step's top-2 margin, replayed teacher-forced, asserted above 5e-3 *
max|logits|. The weights' seed of each family is one whose margins clear
that limit (the tiny random models' top-2 gaps are often smaller: JAX's
jitted engine can then leave its own eager path, ROADMAP.md Queue C).
"""
import dataclasses

import pytest

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine

from test_torch_checkpoint import greedy_with_margins
from test_torch_families import FAMILIES, build, one_thread  # noqa: F401

PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
# the seed of each family's weights: one whose top-2 margins clear the
# limit under both policies (asserted)
GREEDY_SEED = {"qwen2": 2, "qwen3": 11, "phi3": 10,
               "phi3_partial_longrope": 1, "gemma": 0, "llama3": 2}


@pytest.mark.parametrize("attn_impl,kv_dtype", [("auto", "bfloat16"),
                                                ("flash", "int8")])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_tokens_match_jax(family, attn_impl, kv_dtype):
    cfg, tcfg, jp, jspecs, tp, tspecs = build(family, GREEDY_SEED[family],
                                              "w8a8")
    jspecs = dataclasses.replace(jspecs, attn_impl=attn_impl)
    tspecs = dataclasses.replace(tspecs, attn_impl=attn_impl)
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(device_decode_loop=False,
                                                  **ecfg))
    eng = InferenceEngine(tp, tcfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    head_major = attn_impl == "flash"
    assert eng.new_cache(1, 128).head_major is head_major
    assert greedy_with_margins(eng, PROMPTS, NEW) == jeng.generate(PROMPTS,
                                                                   NEW)
