"""PyTorch port, the continuous-batching engine
(mixq_tpu_torch/engine/batching.py::ContinuousBatchingEngine) against JAX's
(mixq_tpu/engine/batching.py), on the CPU, mirroring
tests/test_continuous_batching.py.

- Greedy tokens equal JAX's engine on one script (6 requests on 3 slots,
  prompts of 1 to 11 tokens, budgets of 3 to 9) under both pool layouts:
  "auto" with bf16 KV (batch-major, kernel 8's plain version) and "flash"
  with int8 KV (head-major, kernel 3's), each with the tiny FP16 and
  W8A8O16 llamas of tests/test_torch_models.py. Seed 3 is one whose top-2
  margins stay above 5e-3 * max|logits| along every request's tokens
  (replayed teacher-forced on the port), which the test asserts, as JAX's
  jitted forward leaves its eager one at near-ties (ROADMAP.md Queue C).
  The logprobs of finished_records are within 1e-2 * max|logits| of
  JAX's: twice the decoder tests' logits limit, since an error e in the
  logits moves a log-softmax by at most 2e.
- On the port alone: windows equal single steps; staggered arrivals, more
  requests than slots and a single-token prompt; EOS and per-request stop
  sets, windowed and stepwise; a sampled request beside greedy ones leaves
  them as they were; the refusals (meshes and pipeline stages; CPU params
  without device="cpu"; a failed scheduler build); the engine's scheduler is the native one; params of
  another embedding and head assigned to an engine that has served give a
  fresh engine's tokens and logprobs.
- Chunked admission (prefill_token_budget) equal to unchunked on both
  layouts, and the reference's fault: JAX's head-major pool prefills a
  continuation chunk over its own tokens only, so its chunked tokens leave
  its unchunked ones, while the port's chunked head-major admission equals
  JAX's batch-major chunked admission (ROADMAP.md Queue C).
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import ModelConfig as JModelConfig
from mixq_tpu.engine.batching import ContinuousBatchingEngine as JCB
from mixq_tpu.models import DecoderSpecs as JSpecs
from mixq_tpu.models.decoder import init_decoder_params as j_init
from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.engine import InferenceEngine, SamplingParams
from mixq_tpu_torch.engine import scheduler as S
from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
from mixq_tpu_torch.engine.scheduler import NativeScheduler
from mixq_tpu_torch.models.decoder import DecoderSpecs, forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

PROMPTS = [[3, 1, 4, 1, 5], [2, 7], [9, 9, 8, 2, 1, 8, 2, 8], [5],
           [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21], [40, 41, 42]]
BUDGETS = [7, 9, 5, 6, 3, 8]
LAYOUTS = [("auto", "bfloat16"), ("flash", "int8")]
SEED = 3


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for quantized in (False, True):
        out[quantized] = models.build(SEED, quantized=quantized)
    return out


def ecfg(E, kv, **kw):
    base = dict(max_batch_size=3, max_seq_len=64, prefill_chunk=8,
                kv_dtype=kv)
    base.update(kw)
    return E(**base)


def port_engine(world, attn, kv, **kw):
    cfg, _, _, tp, tspecs = world
    return ContinuousBatchingEngine(
        tp, cfg, dataclasses.replace(tspecs, attn_impl=attn),
        ecfg(EngineConfig, kv, **kw), device="cpu")


def serve(eng, prompts=PROMPTS, budgets=BUDGETS, **run):
    ids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
    out = eng.run_to_completion(**run)
    return [out[i] for i in ids]


def assert_margins(eng, prompts, outputs, rel=5e-3):
    """Replays each request's tokens teacher-forced through the port's
    forward on a cache of the engine's layout and KV type; every step's
    top-2 margin clears rel * max|logits|. Returns the largest |logits|."""
    cfg = eng.cfg
    most = 0.0
    head = lm_head_f32(eng.params, eng.specs)
    for prompt, out in zip(prompts, outputs):
        cache = KVCache.create(
            cfg.num_hidden_layers, 1, 64, cfg.num_key_value_heads,
            cfg.head_dim_, eng.cache.k.dtype,
            head_major=eng.cache.head_major, device="cpu")
        logits, _ = forward(eng.params, torch.tensor([prompt]), cache,
                            eng.specs, cfg, head_f32=head)
        for i, tok in enumerate(out):
            last = logits[0, -1]
            most = max(most, last.abs().max().item())
            top2 = torch.topk(last, 2).values
            assert top2[0] - top2[1] > rel * last.abs().max(), (prompt, i)
            assert int(torch.argmax(last)) == tok
            logits, _ = forward(eng.params, torch.tensor([[tok]]), cache,
                                eng.specs, cfg, head_f32=head)
    return most


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_greedy_tokens_equal_jax(worlds, attn, kv, quantized):
    world = worlds[quantized]
    cfg, jp, jspecs = world[:3]
    jeng = JCB(jp, cfg, dataclasses.replace(jspecs, attn_impl=attn),
               ecfg(JEngineConfig, kv))
    ids = [jeng.add_request(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    while jeng.has_work:
        jeng.step_window()
    jrec = jeng.finished_records()
    eng = port_engine(world, attn, kv)
    assert eng.cache.head_major == jeng.cache.head_major == (kv == "int8")
    rids = [eng.add_request(p, b) for p, b in zip(PROMPTS, BUDGETS)]
    while eng.has_work:
        eng.step_window()
    rec = eng.finished_records()
    got = [rec[r]["tokens"] for r in rids]
    assert got == [jrec[i]["tokens"] for i in ids]
    assert [len(g) for g in got] == BUDGETS
    most = assert_margins(eng, PROMPTS, got)
    for r, i in zip(rids, ids):
        np.testing.assert_allclose(rec[r]["logprobs"], jrec[i]["logprobs"],
                                   rtol=0, atol=1e-2 * most)
        assert all(lp <= 0 for lp in rec[r]["logprobs"])


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_window_equals_steps(worlds, attn, kv):
    world = worlds[True]
    got = serve(port_engine(world, attn, kv))
    ref = serve(port_engine(world, attn, kv, device_decode_loop=False))
    assert got == ref


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_staggered_arrivals_and_reuse(worlds, attn, kv):
    """A request that arrives mid-flight, on a pool of 2 slots reused by 5
    requests, equals the same prompt served alone by the static engine; a
    single-token prompt serves too."""
    world = worlds[True]
    cfg, _, _, tp, tspecs = world
    eng = port_engine(world, attn, kv, max_batch_size=2)
    r1 = eng.add_request(PROMPTS[0], 8)
    for _ in range(3):
        eng.step()
    others = [eng.add_request(p, 4) for p in ([2, 7], [5], [9, 9, 8], [6])]
    out = eng.run_to_completion()
    static = InferenceEngine(tp, cfg, dataclasses.replace(
        tspecs, attn_impl=attn), EngineConfig(
            max_seq_len=64, prefill_chunk=8, kv_dtype=kv), device="cpu")
    assert out[r1] == static.generate([PROMPTS[0]], max_new_tokens=8)[0]
    assert all(len(out[r]) == 4 for r in others)
    assert eng.stats() == {"queued": 0, "active": 0, "finished": 5,
                           "free": 2}


@pytest.mark.parametrize("windowed", [True, False])
def test_eos_and_stop_sets(worlds, windowed):
    world = worlds[True]
    full = serve(port_engine(world, "flash", "int8"))
    eos = full[0][2]                    # request 0's third token as EOS
    got = serve(port_engine(world, "flash", "int8",
                            device_decode_loop=windowed), eos_token_id=eos)
    for g, f in zip(got, full):
        cut = f[:f.index(eos) + 1] if eos in f else f
        assert g == cut
    # a stop set on request 1 only: its neighbours are unaffected
    stop = full[1][4]
    eng = port_engine(world, "flash", "int8", device_decode_loop=windowed)
    ids = [eng.add_request(p, b, stop_token_ids=[stop] if i == 1 else None)
           for i, (p, b) in enumerate(zip(PROMPTS, BUDGETS))]
    out = eng.run_to_completion()
    assert out[ids[1]] == full[1][:full[1].index(stop) + 1]
    assert [out[i] for i in ids[:1] + ids[2:]] == full[:1] + full[2:]


@pytest.mark.parametrize("windowed", [True, False])
def test_sampled_request_leaves_greedy_rows(worlds, windowed):
    world = worlds[True]

    def run(with_sampled):
        eng = port_engine(world, "auto", "bfloat16",
                          device_decode_loop=windowed)
        g = [eng.add_request(p, 9) for p in PROMPTS[:2]]
        s = (eng.add_request([9, 9, 8], 9, sampling=SamplingParams(
            temperature=0.9, top_k=8)) if with_sampled else None)
        out = eng.run_to_completion()
        return [out[r] for r in g], (out[s] if s is not None else None)

    ref, _ = run(False)
    got, sampled = run(True)
    assert got == ref and len(sampled) == 9


CHUNK_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], [2, 7, 1, 8, 2, 8],
                 [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3, 4, 5, 6], [4, 2]]


@pytest.fixture(scope="module")
def tiny_fp():
    """The chunked-admission probe's model (ROADMAP.md Queue C):
    ModelConfig.tiny() in FP16 (JAX's test model), on both sides."""
    cfg = JModelConfig.tiny()
    jp = j_init(jax.random.PRNGKey(0), cfg)
    tp = decoder_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg, jp, ModelConfig.from_dict(cfg.to_dict()), tp


def chunk_cfg(E, kv, budget):
    return E(max_batch_size=4, max_seq_len=64, prefill_chunk=4,
             prefill_token_budget=budget, kv_dtype=kv)


def port_chunked(tiny_fp, attn, kv, budget):
    _, _, cfg, tp = tiny_fp
    eng = ContinuousBatchingEngine(
        tp, cfg, dataclasses.replace(DecoderSpecs.fp16(), attn_impl=attn),
        chunk_cfg(EngineConfig, kv, budget), device="cpu")
    return eng, serve(eng, CHUNK_PROMPTS, [6] * 4)


def jax_chunked(tiny_fp, attn, kv, budget):
    cfg, jp, _, _ = tiny_fp
    eng = JCB(jp, cfg, dataclasses.replace(JSpecs.fp16(), attn_impl=attn),
              chunk_cfg(JEngineConfig, kv, budget))
    return eng, serve(eng, CHUNK_PROMPTS, [6] * 4)


@pytest.mark.parametrize("attn", ["flash", "xla"])
@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_chunked_equals_unchunked(tiny_fp, attn, kv):
    """Budget 8 at k_pad = 4, Tp = 16: four continuation chunks of 4."""
    eng, chunked = port_chunked(tiny_fp, attn, kv, 8)
    assert eng.cache.head_major == (attn == "flash")
    assert chunked == port_chunked(tiny_fp, attn, kv, 0)[1]


@pytest.mark.parametrize("kv", ["int8", "bfloat16"])
def test_chunked_head_major_equals_jax_batch_major(tiny_fp, kv):
    jhm, jax_hm = jax_chunked(tiny_fp, "flash", kv, 8)
    jbm, jax_bm = jax_chunked(tiny_fp, "xla", kv, 8)
    assert jhm.cache.head_major and not jbm.cache.head_major
    eng, port_hm = port_chunked(tiny_fp, "flash", kv, 8)
    assert eng.cache.head_major
    # the reference's fault: its head-major chunked tokens differ (the two
    # longest prompts); the port's equal JAX's batch-major pool's
    assert jax_hm != jax_bm
    assert [a != b for a, b in zip(jax_hm, jax_bm)] == [True, False, True,
                                                         False]
    assert port_hm == jax_bm


def test_refusals(worlds, tmp_path, monkeypatch):
    world = worlds[True]
    cfg, _, _, tp, tspecs = world
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        port_engine(world, "auto", "bfloat16", pipe_stages=2)
    with pytest.raises(NotImplementedError, match="Queue A item 9"):
        ContinuousBatchingEngine(tp, cfg, tspecs, mesh=object(),
                                 device="cpu")
    eng = port_engine(world, "auto", "bfloat16")
    assert isinstance(eng.sched, NativeScheduler)
    # the pool runs on the card unless the caller asks for the CPU
    assert inspect.signature(ContinuousBatchingEngine).parameters[
        "device"].default == "cuda"
    with pytest.raises(ValueError, match="params live on cpu"):
        ContinuousBatchingEngine(tp, cfg, tspecs, EngineConfig(
            max_batch_size=2, max_seq_len=32))
    # a graph never outlives the params it was captured on
    eng._graphs[False] = object()
    eng.params = eng.params
    assert not eng._graphs
    # a failed scheduler build raises: nothing falls back to Python
    bad = tmp_path / "scheduler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(S, "SOURCE", bad)
    monkeypatch.setattr(S, "BUILD_DIR", tmp_path / "build")
    S._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            port_engine(world, "auto", "bfloat16")
    finally:
        S._lib.cache_clear()


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_params_swap_serves_as_a_fresh_engine(worlds, attn, kv):
    """An engine that has served takes params of another seed (another
    embedding and head): it widens their head, and serves the script with
    the tokens and logprobs of a fresh engine built on them."""
    other = models.build(SEED + 1, quantized=True)
    eng = port_engine(worlds[True], attn, kv)
    before = serve(eng)
    eng.params = other[3]
    assert torch.equal(eng.head_f32, lm_head_f32(other[3], eng.specs))
    fresh = port_engine(other, attn, kv)
    got, ref = [], []
    for e, out in ((eng, got), (fresh, ref)):
        ids = [e.add_request(p, b) for p, b in zip(PROMPTS, BUDGETS)]
        while e.has_work:
            e.step_window()
        rec = e.finished_records()
        out.extend((rec[i]["tokens"], rec[i]["logprobs"]) for i in ids)
    assert got == ref
    assert [t for t, _ in got] != before
