"""PyTorch port, prompt-lookup speculative decoding
(mixq_tpu_torch/engine/speculative.py) against JAX's
(mixq_tpu/engine/speculative.py), on the CPU, mirroring
tests/test_speculative.py and the drafting tests of tests/test_cb_spec.py.

- propose_ngram equals JAX's on the fixed cases (the latest match, no
  match, recency, a short history) and on seeded random repetitive
  histories; propose_ngram_device equals JAX's row for row, draft lengths
  included, on seeded batches (n = 1, 2, 3; k = 1, 3, 7; short and full
  histories); accept_greedy equals JAX's on fixed and seeded inputs.
- generate_speculative's tokens and stats (forwards, drafted, accepted)
  equal JAX's generate_speculative, and its tokens equal the port's greedy
  generate, on the tiny FP16 and W8A8O16 llamas of tests/test_torch_models.py
  (bf16 KV, the batch-major cache), for a repetitive, an arbitrary and a
  one-token prompt. JAX runs eagerly (`jax.disable_jit()`): its jitted
  verify and generate leave its eager path on the W8A8O16 model at the
  one-token prompt's 10th token, whose top-2 margin is 2.4e-3 of
  max|logits| (JAX's jit-vs-eager spread, ROADMAP.md Queue C); the port
  equals the eager path. The top-2 margins along every prompt's 24 tokens
  (teacher-forced on the port) are asserted above 2e-4 * max|logits|,
  2,000 times the port's distance from JAX's eager forward
  (tests/test_torch_decoder.py).
- EOS stops generation at its first occurrence, kept in the output.
"""
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine import InferenceEngine as JInferenceEngine
from mixq_tpu.engine import speculative as JS
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.engine import speculative as S
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

SEED = 1
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [3, 1, 4, 1, 5, 9, 2], [42]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_propose_ngram_fixed_cases():
    for fn in (S.propose_ngram, JS.propose_ngram):
        assert fn([1, 2, 3, 9, 8, 1, 2, 3, 4, 5, 1, 2, 3], 3, 4) == [4, 5,
                                                                    1, 2]
        assert fn([1, 2, 3, 4], 2, 4) == []          # no match
        assert fn([1, 2], 3, 4) == []                # a short history
        assert fn([7, 7, 1, 7, 7, 2, 7, 7], 2, 1) == [2]   # recency


def _histories(rng, B, H):
    hists, hlens, rows = np.zeros((B, H), np.int32), np.zeros(B, np.int32), []
    for b in range(B):
        base = [rng.randrange(0, 6) for _ in range(rng.randint(1, 8))]
        h = (base * 12)[:rng.choice([rng.randint(1, H), H])]
        rows.append(h)
        hists[b, :len(h)] = h
        hlens[b] = len(h)
    return hists, hlens, rows


@pytest.mark.parametrize("seed", [0, 1])
def test_propose_ngram_equals_jax(seed):
    rng = random.Random(seed)
    for _ in range(60):
        _, _, (h,) = _histories(rng, 1, 48)
        for n in (1, 2, 3):
            for k in (1, 4, 8):
                assert S.propose_ngram(h, n, k) == JS.propose_ngram(h, n, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_propose_ngram_device_equals_jax(seed):
    """Row for row against JAX's propose_ngram_device and the host
    propose_ngram, full histories (hlen = H) among them."""
    rng = random.Random(seed)
    H = 48
    for _ in range(20):
        hists, hlens, rows = _histories(rng, rng.randint(1, 5), H)
        for n in (1, 2, 3):
            for k in (1, 3, 7):
                d, dl = S.propose_ngram_device(torch.from_numpy(hists),
                                               torch.from_numpy(hlens), n, k)
                jd, jdl = JS.propose_ngram_device(jnp.asarray(hists),
                                                  jnp.asarray(hlens), n, k)
                assert d.dtype == dl.dtype == torch.int32
                assert np.array_equal(dl.numpy(), np.asarray(jdl))
                for b, h in enumerate(rows):
                    want = S.propose_ngram(h, n, k)
                    assert dl[b] == len(want)
                    assert d[b, :dl[b]].tolist() == want
                    assert np.array_equal(d[b, :dl[b]].numpy(),
                                          np.asarray(jd)[b, :jdl[b]])


def test_accept_greedy_equals_jax():
    preds = np.array([[3, 4, 5], [3, 9, 5], [7, 8, 9]], np.int32)
    draft = np.array([[3, 4, 5], [3, 4, 5], [7, 8, 9]], np.int32)
    dlen = np.array([3, 3, 1], np.int32)
    got = S.accept_greedy(*map(torch.from_numpy, (preds, draft, dlen)))
    assert got.dtype == torch.int32 and got.tolist() == [3, 1, 1]
    rng = np.random.default_rng(4)
    for _ in range(20):
        preds = rng.integers(0, 3, (6, 5)).astype(np.int32)
        draft = rng.integers(0, 3, (6, 5)).astype(np.int32)
        dlen = rng.integers(0, 6, (6,)).astype(np.int32)
        got = S.accept_greedy(*map(torch.from_numpy, (preds, draft, dlen)))
        want = JS.accept_greedy(*map(jnp.asarray, (preds, draft, dlen)))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def engines():
    out = {}
    for quantized in (False, True):
        cfg, jp, jspecs, tp, tspecs = models.build(SEED, quantized=quantized)
        jeng = JInferenceEngine(
            jp, cfg, dataclasses.replace(jspecs, attn_impl="auto"),
            JEngineConfig(max_seq_len=128, prefill_chunk=8,
                          device_decode_loop=False))
        teng = InferenceEngine(
            tp, cfg, dataclasses.replace(tspecs, attn_impl="auto"),
            EngineConfig(max_seq_len=128, prefill_chunk=8), device="cpu")
        out[quantized] = (jeng, teng)
    return out


def assert_margins(eng, prompt, out, rel=2e-4):
    """Teacher-forced replay on a batch-major cache: every step's top-2
    margin clears rel * max|logits| and its argmax is the token."""
    cfg = eng.model_cfg
    head = lm_head_f32(eng.params, eng.specs)
    cache = KVCache.create(cfg.num_hidden_layers, 1, 128,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           device="cpu")
    logits, _ = forward(eng.params, torch.tensor([prompt]), cache, eng.specs,
                        cfg, head_f32=head)
    for i, tok in enumerate(out):
        last = logits[0, -1]
        top2 = torch.topk(last, 2).values
        assert top2[0] - top2[1] > rel * last.abs().max(), (prompt, i)
        assert int(torch.argmax(last)) == tok
        logits, _ = forward(eng.params, torch.tensor([[tok]]), cache,
                            eng.specs, cfg, head_f32=head)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("prompt", PROMPTS)
def test_generate_speculative_equals_jax_and_greedy(engines, quantized,
                                                    prompt):
    jeng, teng = engines[quantized]
    got, stats = S.generate_speculative(teng, prompt, max_new_tokens=24,
                                        k=6)
    with jax.disable_jit():
        jgot, jstats = JS.generate_speculative(jeng, prompt,
                                               max_new_tokens=24, k=6)
    assert got == jgot and stats == jstats
    assert got == teng.generate([prompt], max_new_tokens=24)[0]
    assert_margins(teng, prompt, got)
    assert 1 <= stats["forwards"] <= len(got)


def test_acceptance_on_a_repetitive_prompt(engines):
    _, teng = engines[True]
    prompt = [9, 9, 8, 9, 9, 8, 9, 9, 8]
    got, stats = S.generate_speculative(teng, prompt, max_new_tokens=48, k=8)
    assert len(got) == 48
    assert got == teng.generate([prompt], max_new_tokens=48)[0]
    assert stats["accepted"] > 0 and stats["forwards"] < len(got)


def test_eos_stops(engines):
    _, teng = engines[True]
    full, _ = S.generate_speculative(teng, [3, 1, 4], max_new_tokens=16, k=4)
    eos = full[5]
    got, _ = S.generate_speculative(teng, [3, 1, 4], max_new_tokens=16, k=4,
                                    eos_token_id=eos)
    assert got == full[:full.index(eos) + 1]
    with pytest.raises(ValueError, match="empty prompt"):
        S.generate_speculative(teng, [], max_new_tokens=4)
