"""PyTorch port, engine snapshot / restore and warmup
(mixq_tpu_torch/engine/batching.py) and the schedulers' restore_slot, on
the CPU, mirroring tests/test_snapshot.py and the warmup test of
tests/test_cb_spec.py.

- restore_slot: the native scheduler, the port's Python one and JAX's
  PythonScheduler agree (a slot taken, an occupied slot, a request already
  done), and so do their slot_info and stats after.
- A pool snapshotted after its first window and restored into a new engine
  continues with the greedy tokens and logprobs of the uninterrupted run,
  which equal JAX's engine's (tests/test_torch_batching.py's script, seed
  and margins), on both pool layouts; queued requests keep their ids and
  order; sampled rows continue reproducibly (the generator's state is
  restored); the spec engine round-trips through step_serve; snapshot
  drains async windows first, under the EOS they were dispatched with;
  state.npz holds the port's cache layout (bf16 as its bits) and restore
  refuses a pool of another shape.
- warmup returns its count of programs (on the CPU the admission prefill
  plans, JAX's buckets; on the card also the window graphs, which
  tests/test_torch_gpu.py holds), refuses a pool with active slots, and
  leaves the tokens and the generator as they were.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine.batching import ContinuousBatchingEngine as JCB
from mixq_tpu.engine.scheduler import PythonScheduler as JPythonScheduler
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import SamplingParams
from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
from mixq_tpu_torch.engine.scheduler import NativeScheduler, PythonScheduler

import test_torch_batching as tb
import test_torch_models as models


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return models.build(tb.SEED, quantized=True)


def restore(world, path, attn="auto", kv="bfloat16", **kw):
    cfg, _, _, tp, tspecs = world
    return ContinuousBatchingEngine.restore(
        path, tp, cfg, dataclasses.replace(tspecs, attn_impl=attn),
        tb.ecfg(EngineConfig, kv, **kw), device="cpu")


def serve(eng, step="step_window", snap_at=None, reopen=None, **kw):
    """Records of every request (by id), snapshotting after window
    `snap_at` and continuing on the engine `reopen()` restores."""
    recs, w = {}, 0
    while eng.has_work:
        getattr(eng, step)(**kw)
        recs.update(eng.finished_records())
        w += 1
        if w == snap_at:
            eng = reopen(eng)
        assert w < 500
    recs.update(eng.finished_records())
    return recs, eng


def test_restore_slot_parity():
    scheds = [NativeScheduler(4, 32), PythonScheduler(4, 32),
              JPythonScheduler(4, 32)]
    for s in scheds:
        assert s.restore_slot(2, 77, 5, 10, 3) == 0
        assert s.restore_slot(2, 78, 5, 10, 3) == -1   # occupied
        assert s.restore_slot(1, 79, 5, 10, 12) == -2  # done already
        assert s.restore_slot(9, 80, 5, 10, 1) == -1   # no such slot
        assert s.add_request(81, 4, 6) == 0
    assert len({tuple(s.slot_info(2)) for s in scheds}) == 1
    assert scheds[0].slot_info(2) == (77, 5, 3, 10)
    assert scheds[0].stats() == scheds[1].stats() == scheds[2].stats()
    for s in scheds:                   # the restored request runs on
        assert [s.on_token(2) for _ in range(7)] == [0] * 6 + [1]


@pytest.mark.parametrize("attn,kv", tb.LAYOUTS)
def test_greedy_continuation_equals_uninterrupted_and_jax(world, tmp_path,
                                                          attn, kv):
    cfg, jp, jspecs = world[:3]
    jeng = JCB(jp, cfg, dataclasses.replace(jspecs, attn_impl=attn),
               tb.ecfg(JEngineConfig, kv))
    jids = [jeng.add_request(p, b) for p, b in zip(tb.PROMPTS, tb.BUDGETS)]
    jrec, _ = serve(jeng)
    ref_eng = tb.port_engine(world, attn, kv)
    ids = [ref_eng.add_request(p, b) for p, b in zip(tb.PROMPTS, tb.BUDGETS)]
    ref, _ = serve(ref_eng)
    eng = tb.port_engine(world, attn, kv)
    assert [eng.add_request(p, b)
            for p, b in zip(tb.PROMPTS, tb.BUDGETS)] == ids
    path = str(tmp_path / "snap")

    def reopen(e):
        assert e.stats()["queued"] > 0      # 6 requests on 3 slots
        e.snapshot(path)
        return restore(world, path, attn, kv)

    got, eng2 = serve(eng, snap_at=1, reopen=reopen)
    assert got == ref
    assert [got[i]["tokens"] for i in ids] == [jrec[j]["tokens"]
                                               for j in jids]
    assert eng2.cache.head_major == (kv == "int8")


def test_sampled_rows_reproducible(world, tmp_path):
    sp = SamplingParams(temperature=0.8, top_k=8)

    def run(snap_at=None):
        eng = tb.port_engine(world, "auto", "bfloat16")
        for p in tb.PROMPTS[:4]:
            eng.add_request(p, 6, sampling=sp)
        recs, _ = serve(eng, snap_at=snap_at, reopen=lambda e: (
            e.snapshot(str(tmp_path / "s")),
            restore(world, str(tmp_path / "s")))[1])
        return recs

    assert run(None) == run(2)


def test_spec_engine_roundtrip(world, tmp_path):
    prompts = [[5, 3, 5, 3, 5, 3, 5], [2, 7, 2, 7, 2, 7], [9, 9, 8, 9, 9]]

    def run(snap_at=None):
        eng = tb.port_engine(world, "flash", "int8", spec_k=3,
                             max_batch_size=2)
        ids = [eng.add_request(p, 8) for p in prompts]
        recs, eng = serve(eng, "step_serve", snap_at, lambda e: (
            e.snapshot(str(tmp_path / "sp")),
            restore(world, str(tmp_path / "sp"), "flash", "int8", spec_k=3,
                    max_batch_size=2))[1])
        return [recs[i] for i in ids], eng.spec_stats

    (ref, st_ref), (got, st) = run(None), run(1)
    assert got == ref and st == st_ref and st["accepted"] > 0


@pytest.mark.parametrize("eos", [False, True])
def test_snapshot_drains_async(world, tmp_path, eos):
    prompts = [[3, 1, 4, 1, 5], [2, 7], [9]]
    ref_eng = tb.port_engine(world, "auto", "bfloat16", max_batch_size=4)
    ids = [ref_eng.add_request(p, 11) for p in prompts]
    full = ref_eng.run_to_completion()
    stop = full[ids[0]][4] if eos else None
    ref_eng = tb.port_engine(world, "auto", "bfloat16", max_batch_size=4)
    ids = [ref_eng.add_request(p, 11) for p in prompts]
    ref = ref_eng.run_to_completion(eos_token_id=stop)

    eng = tb.port_engine(world, "auto", "bfloat16", max_batch_size=4,
                         async_windows=True)
    ids = [eng.add_request(p, 11) for p in prompts]
    for _ in range(2):
        eng.step_window_async(eos_token_id=stop)
    assert eng._async_inflight is not None
    done = eng.finished()
    eng.snapshot(str(tmp_path / "a"))
    assert eng._async_inflight is None
    eng2 = restore(world, str(tmp_path / "a"), max_batch_size=4)
    out = {**done, **eng2.finished(),
           **eng2.run_to_completion(eos_token_id=stop)}
    assert [out[i] for i in ids] == [ref[i] for i in ids]
    if eos:
        assert out[ids[0]][-1] == stop and len(out[ids[0]]) < 11


def test_snapshot_files_and_mismatch(world, tmp_path):
    eng = tb.port_engine(world, "auto", "bfloat16")
    for p, b in zip(tb.PROMPTS, tb.BUDGETS):
        eng.add_request(p, b)
    eng.step_window()
    path = str(tmp_path / "f")
    eng.snapshot(path)
    data = np.load(os.path.join(path, "state.npz"))
    assert data["cache_k"].dtype == np.int16          # bf16 bits
    assert data["cache_k"].shape == tuple(eng.cache.k.shape)
    assert np.array_equal(data["cache_k"],
                          eng.cache.k.view(torch.int16).numpy())
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert [q["rid"] for q in meta["queued"]] == [3, 4, 5]
    assert (sorted(a["slot"] for a in meta["active"])
            == eng.sched.active_slots() == [1])   # budgets 7, 9, 5; R = 8
    with pytest.raises(ValueError, match="config mismatch"):
        restore(world, path, max_seq_len=32)


def test_warmup(world):
    eng = tb.port_engine(world, "auto", "bfloat16", spec_k=4,
                         max_batch_size=2, max_seq_len=16)
    rng = eng.generator.get_state()
    # JAX's buckets: Tp in {8, 16} x k in {1, 2}, each its own plan
    assert eng.warmup() == 4
    assert torch.equal(eng.generator.get_state(), rng)
    assert eng.captures == 0            # the CPU runs windows eagerly
    rid = eng.add_request([1, 2, 3], 4)
    out = eng.run_to_completion()
    fresh = tb.port_engine(world, "auto", "bfloat16", spec_k=4,
                           max_batch_size=2, max_seq_len=16)
    r2 = fresh.add_request([1, 2, 3], 4)
    assert out[rid] == fresh.run_to_completion()[r2]
    assert len(out[rid]) == 4
    eng.add_request([4, 5], 10)
    eng.step_window()
    with pytest.raises(RuntimeError, match="no active slot"):
        eng.warmup()
    # a budgeted admission plan: k_pad * Tp past the budget chunks
    eng = tb.port_engine(world, "flash", "int8", max_batch_size=4,
                         max_seq_len=16, prefill_token_budget=16)
    assert eng.warmup(prompt_buckets=[16], group_sizes=[1, 2, 4]) == 3
