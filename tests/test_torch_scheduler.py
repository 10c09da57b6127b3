"""PyTorch port, the continuous-batching scheduler
(mixq_tpu_torch/engine/scheduler.py) against the JAX package's
(mixq_tpu/engine/scheduler.py), mirroring tests/test_continuous_batching.py::
TestScheduler.

- The port's native scheduler (its own build of native/scheduler.cpp), the
  port's Python one and JAX's PythonScheduler give the same result for every
  op of a 200-op random script (add, admit, on_token, finish), and the same
  stats and active slots after each.
- FCFS admission and capacity, the token budget clamped to the sequence
  budget, invalid requests: both port schedulers.
- No quiet fallback: NativeScheduler raises when the library cannot be
  built; the library is the port's own build, not the JAX
  package's native/libmixq_sched.so.
"""
import random

import pytest

from mixq_tpu.engine.scheduler import PythonScheduler as JPythonScheduler
from mixq_tpu_torch.engine import scheduler as S
from mixq_tpu_torch.engine.scheduler import NativeScheduler, PythonScheduler


def make(native, n_slots, max_seq):
    return (NativeScheduler if native else PythonScheduler)(n_slots, max_seq)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_python_and_jax_agree(seed):
    rng = random.Random(seed)
    scheds = [NativeScheduler(4, 64), PythonScheduler(4, 64),
              JPythonScheduler(4, 64)]
    for step in range(200):
        op = rng.random()
        if op < 0.4:
            args = (step, rng.randint(0, 64), rng.randint(0, 80))
            got = [s.add_request(*args) for s in scheds]
        elif op < 0.6:
            got = [s.admit() for s in scheds]
        elif op < 0.9:
            slot = rng.randrange(4)
            got = [s.on_token(slot) for s in scheds]
        else:
            slot = rng.randrange(4)
            got = [s.finish(slot) for s in scheds]
        assert got[0] == got[1] == got[2], (step, got)
        assert scheds[0].stats() == scheds[1].stats() == scheds[2].stats()
        active = [s.active_slots() for s in scheds]
        assert active[0] == active[1] == active[2]
        info = [[s.slot_info(i) for i in range(4)] for s in scheds]
        assert info[0] == info[1] == info[2]


@pytest.mark.parametrize("native", [True, False])
def test_fcfs_and_capacity(native):
    s = make(native, 2, 32)
    for rid in range(3):
        assert s.add_request(rid, 4, 8) == 0
    adm = s.admit()
    assert [a[0] for a in adm] == [0, 1]           # FCFS, capacity 2
    assert s.stats()["queued"] == 1
    s.finish(adm[0][1])                            # frees slot 0
    assert s.admit() == [(2, adm[0][1])]
    assert s.admit(cap=1) == []


@pytest.mark.parametrize("native", [True, False])
def test_token_budget(native):
    s = make(native, 1, 16)
    assert s.add_request(7, 10, 100) == 0          # clamped to 6
    (rid, slot), = s.admit()
    assert s.slot_info(slot) == (7, 10, 0, 6)
    states = [s.on_token(slot) for _ in range(6)]
    assert states == [0] * 5 + [1]
    assert s.stats() == {"queued": 0, "active": 0, "finished": 1, "free": 1}
    assert s.on_token(slot) == -1 and s.finish(slot) == -1


@pytest.mark.parametrize("native", [True, False])
def test_invalid_request(native):
    s = make(native, 1, 16)
    assert s.add_request(0, 0, 5) < 0              # empty prompt
    assert s.add_request(1, 16, 5) < 0             # no room left
    assert s.add_request(2, 4, 0) < 0              # no budget
    assert s.stats()["queued"] == 0


def test_native_is_the_ports_own_build():
    path = S.library_path()
    assert path.parent == S.BUILD_DIR and path.name != "libmixq_sched.so"
    NativeScheduler(1, 8)
    assert path.exists()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "scheduler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(S, "SOURCE", bad)
    monkeypatch.setattr(S, "BUILD_DIR", tmp_path / "build")
    S._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            NativeScheduler(2, 16)
    finally:
        S._lib.cache_clear()
