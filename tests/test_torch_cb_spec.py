"""PyTorch port, speculative decoding in the continuous-batching engine
(mixq_tpu_torch/engine/batching.py: step_spec, step_spec_window,
step_serve) against JAX's (mixq_tpu/engine/batching.py), on the CPU,
mirroring tests/test_cb_spec.py.

- Tokens of step_spec and of step_spec_window equal JAX's spec engine's
  and the port's plain windows' on both pool layouts ("auto" with bf16 KV:
  batch-major, the verify through `attend`; "flash" with int8 KV:
  head-major, the verify through kernel 3's plain version once per token)
  on the tiny W8A8O16 llama of tests/test_torch_models.py, and their
  spec_stats equal JAX's; logprobs within 1e-2 * max|logits| of JAX's (as
  tests/test_torch_batching.py). Seed 4's top-2 margins along every
  request's tokens (teacher-forced on the port) are asserted above 3e-3 *
  max|logits|. JAX's flash pool stages recent tokens in a tail window whose
  numerics are not the port's in-place int8 cache's: at seed 7 JAX's spec
  window leaves JAX's own plain window (ROADMAP.md Queue C), so a seed is
  needed where JAX agrees with itself; the port's spec tokens equal its
  plain ones at every seed tried.
- On the port alone: a budget smaller than spec_k; sampled rows ride along
  (greedy rows unchanged, the sampled row emits its budget), in windows
  and in step_spec; a stop token inside an accepted span and the EOS
  parameter, as plain windows cut them; slot churn with staggered
  arrivals; the brim request (spec engines keep spec_k - 1 positions in
  reserve: a prefix of the plain run, spec_k - 1 shorter); step_serve's
  state machine with stubbed windows, a forced fallback to plain windows
  and back through a resynced probe, tokens unchanged; the draft-noise
  instrument (tokens unchanged, acceptance down); the native drafter
  equals the Python one and JAX's propose_ngram; the refusals (a
  sliding-window model, stacked params) with JAX's exceptions.
"""
import dataclasses
import random

import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine.batching import ContinuousBatchingEngine as JCB
from mixq_tpu.engine.speculative import propose_ngram as j_propose
from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.engine import SamplingParams
from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
from mixq_tpu_torch.engine.scheduler import (NativeDrafter, PythonDrafter,
                                             make_drafter)
from mixq_tpu_torch.models.decoder import init_decoder_params

import test_torch_batching as tb
import test_torch_models as models

SEED = 4
PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6], [2, 9, 2, 9, 2, 9, 2], [1, 3, 8]]
BUDGETS = [12, 10, 8]
LAYOUTS = [("auto", "bfloat16"), ("flash", "int8")]
STOP_PROMPT = [126, 74, 110, 113, 126, 74, 246, 126, 74, 246, 126, 74]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return models.build(SEED, quantized=True)


def ecfg(E, kv="bfloat16", **kw):
    base = dict(max_batch_size=3, max_seq_len=96, prefill_chunk=8,
                kv_dtype=kv)
    base.update(kw)
    return E(**base)


def engine(world, attn="auto", kv="bfloat16", **kw):
    cfg, _, _, tp, tspecs = world
    return ContinuousBatchingEngine(
        tp, cfg, dataclasses.replace(tspecs, attn_impl=attn),
        ecfg(EngineConfig, kv, **kw), device="cpu")


def drive(eng, mode, prompts=PROMPTS, budgets=BUDGETS, **kw):
    ids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
    recs, steps = {}, 0
    while eng.has_work:
        getattr(eng, mode)(**kw)
        recs.update(eng.finished_records())
        steps += 1
        assert steps < 400
    return [recs[i] for i in ids]


@pytest.mark.parametrize("mode", ["step_spec_window", "step_spec"])
@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_tokens_equal_jax_and_plain(world, attn, kv, mode):
    cfg, jp, jspecs = world[:3]
    jeng = JCB(jp, cfg, dataclasses.replace(jspecs, attn_impl=attn),
               ecfg(JEngineConfig, kv, spec_k=4))
    jrec = drive(jeng, mode)
    eng = engine(world, attn, kv, spec_k=4)
    assert eng.cache.head_major == (kv == "int8")
    rec = drive(eng, mode)
    plain = drive(engine(world, attn, kv), "step_window")
    got = [r["tokens"] for r in rec]
    assert got == [r["tokens"] for r in jrec] == [r["tokens"] for r in plain]
    assert [len(g) for g in got] == BUDGETS
    assert eng.spec_stats == jeng.spec_stats
    assert eng.spec_stats["accepted"] > 0
    assert eng.spec_stats["forwards"] < eng.spec_stats["emitted"]
    most = tb.assert_margins(eng, PROMPTS, got, rel=3e-3)
    for r, j in zip(rec, jrec):
        np.testing.assert_allclose(r["logprobs"], j["logprobs"], rtol=0,
                                   atol=1e-2 * most)


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_spec_window_equals_step_spec(world, attn, kv):
    win = drive(engine(world, attn, kv, spec_k=4), "step_spec_window")
    host = drive(engine(world, attn, kv, spec_k=4), "step_spec")
    assert win == host


def test_budget_smaller_than_spec_k(world):
    ref = drive(engine(world), "step_window", PROMPTS[:1], [3])
    for mode in ("step_spec", "step_spec_window"):
        got = drive(engine(world, spec_k=6), mode, PROMPTS[:1], [3])
        assert got == ref and len(got[0]["tokens"]) == 3


@pytest.mark.parametrize("mode", ["step_spec_window", "step_spec"])
def test_sampled_rows_ride_along(world, mode):
    def run(with_sampled, spec_k):
        eng = engine(world, spec_k=spec_k)
        g = [eng.add_request(p, 10) for p in PROMPTS[:2]]
        s = (eng.add_request([4, 4, 2], 10, sampling=SamplingParams(
            temperature=0.8, top_k=8)) if with_sampled else None)
        out, steps = {}, 0
        while eng.has_work:
            getattr(eng, mode if spec_k else "step_window")()
            out.update(eng.finished())
            steps += 1
            assert steps < 200
        return [out[r] for r in g], (out[s] if s is not None else None)

    plain, _ = run(False, 0)
    mixed, sampled = run(True, 4)
    assert mixed == plain and len(sampled) == 10


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_stop_token_inside_accepted_span(world, attn, kv):
    """The stop token is one that a verify emits inside a span of accepted
    tokens (not its last): the request ends there, as plain windows end
    it. An accepted token was drafted from the history, so for its first
    output to be inside a span it comes from the prompt: STOP_PROMPT is a
    loop of the seed's model (from its greedy output), which it goes on
    drafting from its first verify."""
    eng = engine(world, attn, kv, spec_k=4)
    rid = eng.add_request(STOP_PROMPT, 16)
    spans, n = [], 0
    while eng.has_work:
        eng.step_spec()
        got = len(eng._outputs.get(rid, eng._done.get(rid, [])))
        spans.append((n, got))
        n = got
    full = eng.finished()[rid]
    inside = [i for a, b in spans for i in range(a, b - 1)
              if full[i] not in full[:i]]
    assert inside
    stop = full[inside[0]]
    want = full[:inside[0] + 1]
    for spec_k, mode in ((0, "step_window"), (4, "step_spec_window"),
                         (4, "step_spec")):
        eng = engine(world, attn, kv, spec_k=spec_k)
        rid = eng.add_request(STOP_PROMPT, 16, stop_token_ids=[stop])
        while eng.has_work:
            getattr(eng, mode)()
        assert eng.finished()[rid] == want


def test_eos_param(world):
    full = drive(engine(world), "step_window", PROMPTS[1:2],
                 [10])[0]["tokens"]
    eos = full[5]
    ref = drive(engine(world), "step_window", PROMPTS[1:2], [10],
                eos_token_id=eos)
    for mode in ("step_spec_window", "step_spec", "step_serve"):
        got = drive(engine(world, spec_k=4), mode, PROMPTS[1:2], [10],
                    eos_token_id=eos)
        assert got == ref and got[0]["tokens"][-1] == eos
    eng = engine(world, spec_k=4)
    rid = eng.add_request(PROMPTS[1], 10)
    assert eng.run_to_completion(eos_token_id=eos)[rid] == ref[0]["tokens"]


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_churn_with_staggered_arrivals(world, attn, kv):
    rng = random.Random(13)
    prompts = []
    for _ in range(8):
        base = [rng.randrange(1, 250) for _ in range(rng.randint(2, 5))]
        prompts.append((base * 3)[:rng.randint(3, 12)])
    budgets = [rng.randint(1, 12) for _ in prompts]

    def run(spec_k):
        r = random.Random(5)
        eng = engine(world, attn, kv, spec_k=spec_k)
        ids, results, pending, steps = [], {}, list(zip(prompts, budgets)), 0
        while pending or eng.has_work:
            if pending and r.random() < 0.6:
                p, b = pending.pop(0)
                ids.append(eng.add_request(p, b))
            eng.step_spec_window() if spec_k else eng.step_window()
            results.update(eng.finished())
            steps += 1
            assert steps < 800
        return [results[i] for i in ids]

    assert run(4) == run(0)


@pytest.mark.parametrize("attn,kv", LAYOUTS)
def test_brim_request(world, attn, kv):
    """A request that fills the cache: the spec run keeps spec_k - 1
    positions in reserve and emits a prefix of the plain run, never a token
    computed at a clamped position."""
    max_seq, k = 32, 4

    def run(spec_k, mode):
        eng = engine(world, attn, kv, spec_k=spec_k, max_batch_size=2,
                     max_seq_len=max_seq)
        rid = eng.add_request(PROMPTS[0], 1000)   # clamped to the room
        while eng.has_work:
            getattr(eng, mode)()
        return eng.finished()[rid]

    ref = run(0, "step_window")
    assert len(ref) == max_seq - len(PROMPTS[0])
    for mode in ("step_spec_window", "step_spec"):
        got = run(k, mode)
        assert len(got) == max_seq - (k - 1) - len(PROMPTS[0])
        assert got == ref[:len(got)]


def test_step_serve_state_machine(world):
    eng = engine(world, max_batch_size=2, max_seq_len=64, spec_k=4,
                 spec_probe_len=2, spec_probe_every=3, spec_min_gain=1.15)
    calls, gain = [], {"v": 2.0}

    def fake_spec(*a, **k):
        calls.append("spec")
        eng._last_spec_gain = gain["v"]
        return 1

    def fake_plain(*a, **k):
        calls.append("plain")
        return 1

    eng.step_spec_window, eng.step_window = fake_spec, fake_plain
    for _ in range(4):
        eng.step_serve()
    assert eng._spec_mode == "spec" and calls == ["spec"] * 4
    gain["v"] = 1.0                      # speculation stops paying
    for _ in range(2):
        eng.step_serve()
    assert eng._spec_mode == "plain"
    for _ in range(3):                   # spec_probe_every plain windows
        eng.step_serve()
    assert eng._spec_mode == "spec" and calls[-3:] == ["plain"] * 3
    gain["v"] = 2.0
    for _ in range(2):
        eng.step_serve()
    assert eng._spec_mode == "spec" and calls[-2:] == ["spec"] * 2
    # the default threshold: 0.55 * (spec_k + 1)
    eng2 = engine(world, spec_k=4, spec_probe_len=1)
    eng2.step_spec_window = lambda *a, **k: (
        setattr(eng2, "_last_spec_gain", 2.7) or 1)
    eng2.step_serve()
    assert eng2._spec_mode == "plain"


def test_fallback_and_resynced_probe_keep_tokens(world):
    ref = [r["tokens"] for r in drive(engine(world), "step_window",
                                      PROMPTS, [24, 20, 16])]
    eng = engine(world, spec_k=4, spec_min_gain=99.0, spec_probe_len=1,
                 spec_probe_every=2)
    modes, out = [], {}
    ids = [eng.add_request(p, b) for p, b in zip(PROMPTS, [24, 20, 16])]
    resyncs = []
    real = eng._resync_hist
    eng._resync_hist = lambda: (resyncs.append(1), real())[1]
    while eng.has_work:
        before = eng._spec_mode
        eng.step_serve()
        modes.append((before, eng._spec_mode))
        out.update(eng.finished())
    assert [out[i] for i in ids] == ref
    assert ("plain", "plain") in modes and ("plain", "spec") in modes
    assert resyncs
    # a resynced history is the prompt and every token emitted
    eng = engine(world, spec_k=4)
    rid = eng.add_request(PROMPTS[0], 20)
    eng.step_spec_window()
    eng.step_window()
    eng._resync_hist()
    slot = next(s for s, r in eng._slot_req.items() if r == rid)
    want = PROMPTS[0] + eng._outputs[rid]
    assert eng._hlen[slot] == len(want)
    assert eng._hist[slot, :len(want)].tolist() == want


def test_draft_noise_instrument(world):
    def run(noise):
        eng = engine(world, spec_k=4, spec_draft_noise=noise)
        got = [r["tokens"] for r in drive(eng, "step_spec_window")]
        st = eng.spec_stats
        return got, st["accepted"] / max(st["drafted"], 1)

    clean, rate0 = run(0.0)
    noisy, rate9 = run(0.9)
    ref = [r["tokens"] for r in drive(engine(world), "step_window")]
    assert clean == noisy == ref
    assert rate9 < rate0


def test_native_drafter_equals_python_and_jax():
    nat, py = make_drafter(2), PythonDrafter(2)
    assert isinstance(nat, NativeDrafter)
    rng = random.Random(3)
    for trial in range(50):
        base = [rng.randrange(0, 6) for _ in range(rng.randint(1, 8))]
        hist = (base * 4)[:rng.randint(1, 30)]
        slot = trial % 2
        nat.reset(slot, hist)
        py.reset(slot, hist)
        for _ in range(3):
            ext = [rng.randrange(0, 6) for _ in range(rng.randint(0, 4))]
            nat.append(slot, ext)
            py.append(slot, ext)
            hist = hist + ext
            for n in (1, 2, 3):
                for k in (1, 4, 8):
                    want = j_propose(hist, n, k)
                    assert nat.propose(slot, n, k) == want
                    assert py.propose(slot, n, k) == want


def test_refusals(world):
    cfg, _, _, tp, tspecs = world
    win = ModelConfig.from_dict({**cfg.to_dict(), "sliding_window": 16})
    wp = init_decoder_params(win, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        ContinuousBatchingEngine(wp, win, tspecs, ecfg(EngineConfig,
                                                       spec_k=4),
                                 device="cpu")
    with pytest.raises(ValueError, match="stacked"):
        ContinuousBatchingEngine(tp._replace(stacked=tp.blocks[0]), cfg,
                                 tspecs, ecfg(EngineConfig, spec_k=4),
                                 device="cpu")
    eng = engine(world)
    for call in (eng.step_spec, eng.step_spec_window):
        with pytest.raises(ValueError, match="spec_k > 1"):
            call()
