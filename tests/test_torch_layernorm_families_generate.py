"""PyTorch port, the LayerNorm families and chatglm of
tests/test_torch_layernorm_families.py on the CPU: the greedy tokens of
`generate` (W8A8O16 with planted outlier sets) equal JAX's
InferenceEngine's, under "auto" with bf16 KV (batch-major: kernel 8's plain
version) and under "flash" with int8 KV (head-major: kernel 3's), each
step's top-2 margin, replayed teacher-forced, asserted above 5e-3 *
max|logits|; and the continuous-batching engine's tokens for the tiny OPT
(learned positions at each slot's own row positions) equal JAX's under
both pool layouts. The weights' seed of each family is one whose margins
clear that limit (asserted), as tests/test_torch_families_generate.py
picks them.
"""
import dataclasses

import pytest

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.engine.batching import ContinuousBatchingEngine as JCB
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

from test_torch_batching import assert_margins
from test_torch_checkpoint import greedy_with_margins
from test_torch_layernorm_families import (FAMILIES, build,  # noqa: F401
                                           one_thread)

PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
# the seed of each family's weights: one whose top-2 margins clear the
# limit under both policies (asserted)
GREEDY_SEED = {"falcon": 1, "falcon_new": 0, "falcon_alibi": 0, "gptj": 3,
               "opt": 0, "starcoder2": 0, "chatglm": 8}
CB_PROMPTS = [[3, 1, 4, 1, 5], [2, 7], [9, 9, 8, 2, 1, 8, 2, 8], [5],
              [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21], [40, 41, 42]]
CB_BUDGETS = [7, 9, 5, 6, 3, 8]
CB_SEED = 1


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


@pytest.mark.parametrize("attn,kv", [("auto", "bfloat16"), ("flash", "int8")])
def test_cb_tokens_of_learned_positions_match_jax(attn, kv):
    """OPT in the CB pool: each slot's positions (and so its learned
    position rows) are its own, prompts of 1 to 11 tokens on 3 slots."""
    cfg, tcfg, jp, jspecs, tp, tspecs = build("opt", CB_SEED, "w8a8")
    kw = dict(max_batch_size=3, max_seq_len=64, prefill_chunk=8,
              kv_dtype=kv)
    jeng = JCB(jp, cfg, dataclasses.replace(jspecs, attn_impl=attn),
               JEngineConfig(**kw))
    ids = [jeng.add_request(p, b) for p, b in zip(CB_PROMPTS, CB_BUDGETS)]
    while jeng.has_work:
        jeng.step_window()
    jrec = jeng.finished_records()
    eng = ContinuousBatchingEngine(
        tp, tcfg, dataclasses.replace(tspecs, attn_impl=attn),
        EngineConfig(**kw), device="cpu")
    assert eng.cache.head_major == jeng.cache.head_major == (kv == "int8")
    rids = [eng.add_request(p, b) for p, b in zip(CB_PROMPTS, CB_BUDGETS)]
    while eng.has_work:
        eng.step_window()
    rec = eng.finished_records()
    got = [rec[r]["tokens"] for r in rids]
    assert got == [jrec[i]["tokens"] for i in ids]
    assert [len(g) for g in got] == CB_BUDGETS
    assert_margins(eng, CB_PROMPTS, got)
