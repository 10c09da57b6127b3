"""PyTorch port, lag-1 async decode windows
(mixq_tpu_torch/engine/batching.py::step_window_async, drain_async) against
the synchronous windows and JAX's async engine (mixq_tpu/engine/
batching.py), on the CPU, mirroring tests/test_async_window.py.

- Greedy tokens and logprobs of async windows equal JAX's async engine's
  and the port's synchronous windows' on both pool layouts, on
  tests/test_torch_batching.py's script (6 requests on 3 slots) and tiny
  W8A8O16 llama at its seed, whose top-2 margins it asserts (5e-3 *
  max|logits|) here too; 5 requests through 2 slots (slot reuse: a
  finished slot's in-flight tokens never reach its next occupant).
- EOS truncates as in synchronous windows; admissions between async
  windows (the carry spliced only where admission rewrote a slot); the
  window length R does not change tokens; a synchronous step or window, or
  a spec window, after async windows drains first and the tokens are the
  synchronous ones; an empty queue is a no-op; a window's tokens are read
  only after the next window is dispatched.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine.batching import ContinuousBatchingEngine as JCB
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

import test_torch_batching as tb
import test_torch_models as models

PROMPTS = [[3, 1, 4, 1, 5], [2, 7], [9], [8, 2, 8, 1], [6, 6, 1]]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return models.build(tb.SEED, quantized=True)


def engine(world, async_windows, attn="auto", kv="bfloat16", n_slots=2,
           **kw):
    cfg, _, _, tp, tspecs = world
    return ContinuousBatchingEngine(
        tp, cfg, dataclasses.replace(tspecs, attn_impl=attn),
        EngineConfig(max_batch_size=n_slots, max_seq_len=64,
                     prefill_chunk=8, kv_dtype=kv,
                     async_windows=async_windows, **kw), device="cpu")


def run(world, async_windows, prompts=PROMPTS, new=11, eos=None, **kw):
    eng = engine(world, async_windows, **kw)
    ids = [eng.add_request(p, new) for p in prompts]
    out = eng.run_to_completion(eos_token_id=eos)
    return [out[r] for r in ids]


@pytest.mark.parametrize("attn,kv", tb.LAYOUTS)
def test_tokens_equal_jax_and_sync(world, attn, kv):
    cfg, jp, jspecs = world[:3]
    jeng = JCB(jp, cfg, dataclasses.replace(jspecs, attn_impl=attn),
               tb.ecfg(JEngineConfig, kv, async_windows=True))
    jids = [jeng.add_request(p, b) for p, b in zip(tb.PROMPTS, tb.BUDGETS)]
    while jeng.has_work:
        jeng.step_window_async()
    jeng.drain_async()
    jrec = jeng.finished_records()
    recs = []
    for async_windows in (True, False):
        eng = tb.port_engine(world, attn, kv, async_windows=async_windows)
        ids = [eng.add_request(p, b) for p, b in zip(tb.PROMPTS, tb.BUDGETS)]
        while eng.has_work:
            (eng.step_window_async if async_windows else eng.step_window)()
        eng.drain_async()
        rec = eng.finished_records()
        recs.append([rec[i] for i in ids])
    got = [r["tokens"] for r in recs[0]]
    assert got == [jrec[i]["tokens"] for i in jids]
    assert recs[0] == recs[1]
    most = tb.assert_margins(eng, tb.PROMPTS, got)
    for r, i in zip(recs[0], jids):
        np.testing.assert_allclose(r["logprobs"], jrec[i]["logprobs"],
                                   rtol=0, atol=1e-2 * most)


@pytest.mark.parametrize("attn,kv", tb.LAYOUTS)
def test_slot_reuse_matches_sync(world, attn, kv):
    assert (run(world, True, attn=attn, kv=kv)
            == run(world, False, attn=attn, kv=kv))


def test_eos_truncates(world):
    ref = run(world, False)
    eos = ref[0][4]
    got = run(world, True, eos=eos)
    assert got == run(world, False, eos=eos)
    assert got[0][-1] == eos and len(got[0]) <= 11


@pytest.mark.parametrize("attn,kv", tb.LAYOUTS)
def test_staggered_admission(world, attn, kv):
    def go(async_windows):
        eng = engine(world, async_windows, attn, kv, n_slots=4)
        ids = [eng.add_request(p, 9) for p in PROMPTS[:2]]
        for _ in range(2):
            (eng.step_window_async if async_windows else eng.step_window)()
        ids += [eng.add_request(p, 9) for p in PROMPTS[2:]]
        out = eng.run_to_completion()
        return [out[r] for r in ids]

    assert go(True) == go(False)


def test_window_r_knob(world):
    ref = run(world, False)
    for r in (4, 16):
        assert run(world, True, window_r=r) == ref
        assert run(world, False, window_r=r) == ref


def test_drain_composes_with_sync_modes(world):
    ref = run(world, False, prompts=PROMPTS[:3], n_slots=4)
    for sync in ("step_window", "step"):
        eng = engine(world, True, n_slots=4)
        ids = [eng.add_request(p, 11) for p in PROMPTS[:3]]
        eng.step_window_async()
        eng.step_window_async()
        assert eng._async_inflight is not None and eng._async_live
        getattr(eng, sync)()           # drains, then runs synchronously
        assert eng._async_inflight is None
        out = {**eng.finished(), **eng.run_to_completion()}
        assert [out[r] for r in ids] == ref
    # a spec engine: async plain windows, then spec windows
    eng = engine(world, True, n_slots=4, spec_k=4)
    ids = [eng.add_request(p, 11) for p in PROMPTS[:3]]
    eng.step_window_async()
    eng.step_window_async()
    eng.step_spec_window()
    assert eng._async_inflight is None and not eng._async_live
    out = {**eng.finished(), **eng.run_to_completion()}
    assert [out[r] for r in ids] == ref


def test_outputs_read_one_window_late(world):
    eng = engine(world, True)
    rid = eng.add_request(PROMPTS[0], 11)
    eng.step_window_async()
    assert eng._outputs[rid] == []        # dispatched, not read
    eng.step_window_async()
    assert len(eng._outputs[rid]) == eng._window_r
    eng.drain_async()
    assert len(eng._outputs.get(rid, eng._done.get(rid))) == 11


def test_empty_queue_noop(world):
    eng = engine(world, True)
    assert eng.step_window_async() == 0
    rid = eng.add_request([5, 3], 4)
    out = eng.run_to_completion()
    assert len(out[rid]) == 4
