"""PyTorch port, the device decode loop (`engine.DecodeLoop`, JAX's
`_get_decode_loop`) on the CPU, mirroring tests/test_device_loop.py.

On the CPU the loop runs the step that the card captures as a CUDA graph,
eagerly, with the same buffers and the same EOS cadence (the host reads
the EOS mask before the first step and every `engine.DEFAULT_WINDOW`
steps after it).

- Loop against the stepwise host loop (device_decode_loop=False) in the
  port: greedy, sampled from one seeded generator (temperature with top-k,
  and top-p, with logprobs), EOS early exit and trimming at two cadences,
  int8 KV. The loop engine runs `DecodeLoop.step` once per decode step and
  never the stepwise loop.
- The port's default `generate` (device loop on) token-equal to JAX's
  default `generate` (its lax.while_loop) on the tiny W8A8 and W4A4 models
  and seeds of tests/test_torch_engine.py, bf16 and int8 KV, over the
  head-major cache ("flash", kernel 3's plain version) and the batch-major
  one ("xla", kernel 8's), and on tiny gemma2 (seed 13 of
  tests/test_torch_gemma2.py).
- The tiny mistral on an 8-slot ring with a window of 4: the port's loop
  token-equal to JAX's loop over 12 steps past a prefill of 8, so the ring
  wraps twice, bf16 and int8 KV. The port repeats JAX's eager forward
  (tests/test_torch_mistral.py holds the ring's logits to it), and JAX's
  jitted loop leaves its eager forward at near-ties, as JAX's jit does
  elsewhere (ROADMAP.md Queue C); seed 2 is one whose top-2 margins stay
  above 2e-3 of max|logits| at every step, which the test asserts on the
  port's logits.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.engine import SamplingParams as JSamplingParams
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine, SamplingParams
from mixq_tpu_torch.engine import engine as engine_mod
from mixq_tpu_torch.engine.engine import DecodeLoop
from mixq_tpu_torch.engine.sampling import sample
from mixq_tpu_torch.models.layers import KVCache

import test_torch_gemma2 as gemma2
import test_torch_mistral as mistral
import test_torch_models as models

PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
RING_SEED = 2


@pytest.fixture(scope="module")
def world():
    cfg, _, _, tp, tspecs = models.build(1)
    return cfg, tp, tspecs


def engines(world, **cfg_kw):
    cfg, tp, tspecs = world
    base = dict(max_seq_len=64, prefill_chunk=8)
    e_loop = InferenceEngine(tp, cfg, tspecs, EngineConfig(
        **base, device_decode_loop=True, **cfg_kw), device="cpu")
    e_step = InferenceEngine(tp, cfg, tspecs, EngineConfig(
        **base, device_decode_loop=False, **cfg_kw), device="cpu")
    return e_loop, e_step


@contextlib.contextmanager
def loop_only():
    """Counts DecodeLoop.step calls (yields the list of calls) and refuses
    the stepwise loop."""
    calls = []
    real = DecodeLoop.step

    def stepwise(*a, **kw):
        raise AssertionError("the loop engine ran the stepwise loop")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DecodeLoop, "step",
                   lambda self: calls.append(1) or real(self))
        mp.setattr(InferenceEngine, "_stepwise", stepwise)
        yield calls


def test_greedy_matches_stepwise(world):
    e_loop, e_step = engines(world)
    prompts = [[1, 5, 9, 4], [2, 2, 7]]
    ref = e_step.generate(prompts, max_new_tokens=8)
    with loop_only() as calls:
        got = e_loop.generate(prompts, max_new_tokens=8)
    assert got == ref and [len(r) for r in got] == [8, 8]
    assert len(calls) == 7                 # one step per decode step


@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.8, top_k=16),
    SamplingParams(temperature=1.3, top_p=0.9)])
def test_sampled_matches_stepwise(world, sp):
    """One seeded generator, the same draws in the same order: the same
    sampled tokens and logprobs."""
    e_loop, e_step = engines(world)
    got = e_loop.generate(PROMPTS, max_new_tokens=8, sampling=sp, seed=11,
                          return_logprobs=True)
    ref = e_step.generate(PROMPTS, max_new_tokens=8, sampling=sp, seed=11,
                          return_logprobs=True)
    assert got == ref
    # the draws count: another seed samples another stream
    other = e_loop.generate(PROMPTS, max_new_tokens=8, sampling=sp, seed=12)
    assert other != got[0]


@pytest.mark.parametrize("window", [0, 2])
def test_eos_early_exit_and_trim(world, window, monkeypatch):
    """At generate's cadence (window 0: DEFAULT_WINDOW, 8) and at a read
    every 2 steps."""
    if window:
        monkeypatch.setattr(engine_mod, "DEFAULT_WINDOW", window)
    e_loop, e_step = engines(world)
    # the greedy token after this prompt as "EOS", so rows stop
    prompts = [[3, 3, 3], [7, 1]]
    eos = e_step.generate(prompts, max_new_tokens=3)[0][1]
    ref = e_step.generate(prompts, max_new_tokens=24, eos_token_id=eos)
    with loop_only() as calls:
        got = e_loop.generate(prompts, max_new_tokens=24, eos_token_id=eos)
    assert got == ref
    assert got[0][-1] == eos and len(got[0]) == 2
    # the host reads the mask before step 1 and after every `window`
    # steps (8 by default): the loop stops at the first read after the
    # last row's eos, within 23 decode steps
    last = max(len(r) for r in got) - 1
    window = window or 8
    assert len(calls) == min(23, -(-last // window) * window)


def test_all_rows_done_after_prefill(world):
    e_loop, e_step = engines(world)
    eos = e_step.generate([[3, 3, 3]], max_new_tokens=1)[0][0]
    with loop_only() as calls:
        assert e_loop.generate([[3, 3, 3]], max_new_tokens=8,
                               eos_token_id=eos) == [[eos]]
    assert not calls


@pytest.mark.parametrize("slots,new,ok", [(16, 9, True), (16, 10, False)])
def test_loop_refuses_a_cache_too_short(world, slots, new, ok):
    """Replays skip update_layer's host overflow check, so DecodeLoop
    checks up front: a prefill of 8 and new - 1 decode steps fit 16 slots
    only for new <= 9."""
    e_loop, _ = engines(world)
    cache = e_loop.new_cache(1, slots)
    logits, cache = e_loop.prefill(torch.full((1, 8), 3), cache)
    tok = sample(logits, None, SamplingParams())
    args = (e_loop, cache, e_loop._rows(None, 1), tok, new,
            SamplingParams(), None)
    if ok:
        DecodeLoop(*args)
    else:
        with pytest.raises(ValueError, match="cache overflow"):
            DecodeLoop(*args)


def test_loop_takes_a_ring_past_its_slots():
    """A ring (the tiny mistral's 8 slots, window 4) serves any number of
    steps: no overflow check."""
    cfg, _, _, tp, tspecs = mistral.build(RING_SEED)
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(
        max_seq_len=64, prefill_chunk=4), device="cpu")
    cache = eng.new_cache(1, 8)
    assert not cache.head_major
    logits, cache = eng.prefill(torch.full((1, 4), 3), cache)
    tok = sample(logits, None, SamplingParams())
    loop = DecodeLoop(eng, cache, eng._rows(None, 1), tok, 12,
                      SamplingParams(), None)
    loop.run(11, 8)
    assert cache.host_length == int(cache.length) == 4 + 11


def test_int8_kv(world):
    e_loop, e_step = engines(world, kv_dtype="int8")
    prompts = [[4, 4, 4, 4]]
    assert (e_loop.generate(prompts, max_new_tokens=6)
            == e_step.generate(prompts, max_new_tokens=6))


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
@pytest.mark.parametrize("kv_dtype,config,seed", [
    ("bfloat16", None, 1), ("int8", None, 1), ("bfloat16", "w4a4", 8),
    ("int8", "w4a4", 8)])
def test_default_generate_matches_jax_loop(kv_dtype, config, seed,
                                           attn_impl):
    """Both engines' defaults: JAX's while_loop program, the port's loop.
    (tests/test_torch_engine.py asserts these seeds' top-2 margins.)"""
    cfg, jp, jspecs, tp, tspecs = models.build(
        seed=seed, qcfg=models.CONFIGS.get(config))
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    jeng = JEngine(jp, cfg, dataclasses.replace(jspecs, attn_impl=attn_impl),
                   JEngineConfig(**ecfg))
    eng = InferenceEngine(tp, cfg, dataclasses.replace(
        tspecs, attn_impl=attn_impl), EngineConfig(**ecfg), device="cpu")
    assert jeng.engine_cfg.device_decode_loop
    assert eng.engine_cfg.device_decode_loop
    head_major = attn_impl == "flash"
    assert eng.new_cache(4, 128).head_major == head_major
    assert jeng.new_cache(4, 128).head_major == head_major
    assert eng.generate(PROMPTS, NEW) == jeng.generate(PROMPTS, NEW)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_gemma2_default_generate_matches_jax_loop(kv_dtype):
    """Tiny gemma2 at the published caps, seed 13 (its margins asserted in
    tests/test_torch_gemma2.py::test_greedy_tokens_match_jax)."""
    cfg, jp, jspecs, tp, tspecs = gemma2.build(gemma2.GREEDY_SEED, None,
                                               gemma2.gemma2_cfg())
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    ref = JEngine(jp, cfg, jspecs, JEngineConfig(**ecfg)).generate(
        PROMPTS, NEW)
    got = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu").generate(PROMPTS, NEW)
    assert got == ref


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_mistral_ring_loop_past_the_wrap_matches_jax(kv_dtype):
    """An 8-slot ring, window 4: a prefill of two chunks of 4, then 12
    greedy steps of each package's loop (the ring wraps twice), from left-
    padded rows."""
    cfg, jp, jspecs, tp, tspecs = mistral.build(RING_SEED)
    B, S, steps = 3, 8, 12
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (B, 8)).astype(np.int32)
    kv_start = np.array([0, 1, 3], np.int32)
    ecfg = dict(max_seq_len=64, prefill_chunk=4, kv_dtype=kv_dtype)
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)

    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(**ecfg))
    jc = JKVCache.create(L, B, S, nkv, hd, jnp.dtype(kv_dtype))
    for chunk in (toks[:, :4], toks[:, 4:]):
        jlogits, jc = jeng.prefill(jnp.asarray(chunk), jc,
                                   jnp.asarray(kv_start))
    sp = JSamplingParams()
    jtok = jeng._sample(jlogits, None, sp)
    loop = jeng._get_decode_loop(steps, sp)
    jbuf, _, jsteps, _ = loop(jeng.params, jtok, jc, jnp.asarray(kv_start),
                              jax.random.PRNGKey(0),
                              jnp.asarray(-1, jnp.int32))
    ref = np.concatenate([np.asarray(jtok)[:, None], np.asarray(jbuf)], 1)
    assert int(jsteps) == steps

    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    tc = KVCache.create(L, B, S, nkv, hd, getattr(torch, kv_dtype),
                        device="cpu")
    kv_t = torch.from_numpy(kv_start)
    for chunk in (toks[:, :4], toks[:, 4:]):
        logits, tc = eng.prefill(torch.from_numpy(chunk), tc, kv_t)
    tok = sample(logits, None, SamplingParams())
    dl = DecodeLoop(eng, tc, kv_t, tok, steps + 1, SamplingParams(), None)
    margins = [logits]
    for _ in range(steps):
        margins.append(dl.step())
    assert np.array_equal(dl.tokens.numpy(), ref)
    assert tc.host_length == int(tc.length) == 8 + steps > 2 * S
    for lg in margins:
        top2 = torch.topk(lg, 2, dim=-1).values
        assert ((top2[:, 0] - top2[:, 1]).min()
                > 2e-3 * lg.abs().max()), "near-tie"
