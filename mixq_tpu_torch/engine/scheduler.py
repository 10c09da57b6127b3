"""Continuous-batching slot scheduler and n-gram drafters (mirrors
mixq_tpu/engine/scheduler.py): ctypes bindings to the native C++ scheduler
and drafter (native/scheduler.cpp) and pure-Python ones with the same
contract.

Semantics: FCFS admission into free slots; a request occupies one KV-cache
slot from admission until it reaches its token budget (clamped to the
sequence budget), or an explicit finish (EOS, a stop token).

The native library is the port's own build of native/scheduler.cpp, made
at first use with `g++ -O2 -std=c++17 -fPIC -shared` into
mixq_tpu_torch/build/ (its file name carries a hash of the source and the
flags, so an edited source is rebuilt). Nothing is built when this module
is imported. A failed build or load raises: nothing falls back to the
Python scheduler, which runs only where a caller constructs it.

`restore_slot` re-occupies a slot with an in-flight request (engine
snapshot/restore: slot ids are KV-cache row ids). The drafters keep each
slot's token history and propose the prompt-lookup draft of
engine/speculative.py::propose_ngram: `NativeDrafter` over the library's
ngram_* scan (the engine's; `make_drafter`, JAX's name for it, never falls
back), `PythonDrafter` over propose_ngram itself.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR.parent / "native" / "scheduler.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]


def library_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes()
                     + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libmixq_sched_{h}.so"


@functools.cache
def _lib() -> ctypes.CDLL:
    """The loaded native scheduler, built first if needed; raises when the
    source is missing or the build or load fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"native scheduler source not found: {SOURCE}")
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native scheduler build failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native scheduler build failed (rc "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)            # atomic: concurrent builds agree
    lib = ctypes.CDLL(str(path))
    i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
    i32p, i64p = ctypes.POINTER(i32), ctypes.POINTER(i64)
    for name, res, args in (
            ("sched_create", vp, [i32, i32]),
            ("sched_destroy", None, [vp]),
            ("sched_add_request", i32, [vp, i64, i32, i32]),
            ("sched_admit", i32, [vp, i64p, i32p, i32]),
            ("sched_on_token", i32, [vp, i32]),
            ("sched_finish", i32, [vp, i32]),
            ("sched_restore_slot", i32, [vp, i32, i64, i32, i32, i32]),
            ("sched_active_slots", i32, [vp, i32p, i32]),
            ("sched_slot_info", i32, [vp, i32, i64p]),
            ("sched_stats", None, [vp, i64p]),
            ("ngram_create", vp, [i32]),
            ("ngram_destroy", None, [vp]),
            ("ngram_reset", i32, [vp, i32, i32p, i32]),
            ("ngram_append", i32, [vp, i32, i32p, i32]),
            ("ngram_propose", i32, [vp, i32, i32, i32, i32p])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class NativeScheduler:
    """ctypes wrapper over native/scheduler.cpp."""

    def __init__(self, n_slots: int, max_seq: int):
        self._lib = _lib()
        self._h = self._lib.sched_create(n_slots, max_seq)
        if not self._h:
            raise ValueError(f"sched_create({n_slots}, {max_seq}) failed")
        self.n_slots = n_slots

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sched_destroy(self._h)
            self._h = None

    def add_request(self, req_id: int, prompt_len: int,
                    max_new_tokens: int) -> int:
        return self._lib.sched_add_request(self._h, req_id, prompt_len,
                                           max_new_tokens)

    def admit(self, cap: Optional[int] = None) -> List[Tuple[int, int]]:
        cap = cap or self.n_slots
        ids = (ctypes.c_int64 * cap)()
        slots = (ctypes.c_int32 * cap)()
        n = self._lib.sched_admit(self._h, ids, slots, cap)
        return [(ids[i], slots[i]) for i in range(n)]

    def on_token(self, slot: int) -> int:
        return self._lib.sched_on_token(self._h, slot)

    def finish(self, slot: int) -> int:
        return self._lib.sched_finish(self._h, slot)

    def restore_slot(self, slot: int, req_id: int, prompt_len: int,
                     max_new_tokens: int, generated: int) -> int:
        """Re-occupy `slot` with an in-flight request: 0, -1 (slot out of
        range or live), -2 (invalid counts)."""
        return self._lib.sched_restore_slot(self._h, slot, req_id,
                                            prompt_len, max_new_tokens,
                                            generated)

    def active_slots(self) -> List[int]:
        out = (ctypes.c_int32 * self.n_slots)()
        n = self._lib.sched_active_slots(self._h, out, self.n_slots)
        return list(out[:n])

    def slot_info(self, slot: int):
        out = (ctypes.c_int64 * 4)()
        if self._lib.sched_slot_info(self._h, slot, out) != 0:
            return None
        return tuple(out)

    def stats(self):
        out = (ctypes.c_int64 * 4)()
        self._lib.sched_stats(self._h, out)
        return {"queued": out[0], "active": out[1], "finished": out[2],
                "free": out[3]}


@dataclass
class _Req:
    id: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0


class PythonScheduler:
    """Pure-Python scheduler with the native one's contract."""

    def __init__(self, n_slots: int, max_seq: int):
        self.n_slots = n_slots
        self.max_seq = max_seq
        self._queue: deque = deque()
        self._slots: List[Optional[_Req]] = [None] * n_slots
        self._finished = 0

    def add_request(self, req_id, prompt_len, max_new_tokens) -> int:
        if prompt_len <= 0 or prompt_len >= self.max_seq:
            return -2
        mnt = min(max_new_tokens, self.max_seq - prompt_len)
        if mnt <= 0:
            return -2
        self._queue.append(_Req(req_id, prompt_len, mnt))
        return 0

    def admit(self, cap=None):
        cap = cap or self.n_slots
        out = []
        for slot in range(self.n_slots):
            if len(out) >= cap or not self._queue:
                break
            if self._slots[slot] is None:
                r = self._queue.popleft()
                self._slots[slot] = r
                out.append((r.id, slot))
        return out

    def on_token(self, slot) -> int:
        r = self._slots[slot]
        if r is None:
            return -1
        r.generated += 1
        if (r.generated >= r.max_new_tokens
                or r.prompt_len + r.generated >= self.max_seq):
            self._slots[slot] = None
            self._finished += 1
            return 1
        return 0

    def finish(self, slot) -> int:
        if self._slots[slot] is None:
            return -1
        self._slots[slot] = None
        self._finished += 1
        return 0

    def restore_slot(self, slot, req_id, prompt_len, max_new_tokens,
                     generated) -> int:
        if not (0 <= slot < self.n_slots) or self._slots[slot] is not None:
            return -1
        if (prompt_len <= 0 or max_new_tokens <= 0 or generated < 0
                or generated >= max_new_tokens):
            return -2
        self._slots[slot] = _Req(req_id, prompt_len, max_new_tokens,
                                 generated)
        return 0

    def active_slots(self):
        return [i for i, r in enumerate(self._slots) if r is not None]

    def slot_info(self, slot):
        r = self._slots[slot]
        if r is None:
            return None
        return (r.id, r.prompt_len, r.generated, r.max_new_tokens)

    def stats(self):
        active = len(self.active_slots())
        return {"queued": len(self._queue), "active": active,
                "finished": self._finished, "free": self.n_slots - active}



class NativeDrafter:
    """Per-slot prompt-lookup drafter over the native token histories
    (native/scheduler.cpp ngram_*): a flat int32 backward scan per slot."""

    def __init__(self, n_slots: int):
        self._lib = _lib()
        self._h = self._lib.ngram_create(n_slots)
        if not self._h:
            raise ValueError(f"ngram_create({n_slots}) failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ngram_destroy(self._h)
            self._h = None

    @staticmethod
    def _arr(tokens):
        return (ctypes.c_int32 * len(tokens))(*tokens)

    def reset(self, slot: int, tokens) -> None:
        tokens = list(tokens)
        self._lib.ngram_reset(self._h, slot, self._arr(tokens), len(tokens))

    def append(self, slot: int, tokens) -> None:
        tokens = list(tokens)
        self._lib.ngram_append(self._h, slot, self._arr(tokens), len(tokens))

    def propose(self, slot: int, n: int, k: int) -> List[int]:
        out = (ctypes.c_int32 * max(k, 1))()
        got = self._lib.ngram_propose(self._h, slot, n, k, out)
        return list(out[:got])


class PythonDrafter:
    """Pure-Python drafter with the native one's contract."""

    def __init__(self, n_slots: int):
        self._hist: List[List[int]] = [[] for _ in range(n_slots)]

    def reset(self, slot, tokens):
        self._hist[slot] = list(tokens)

    def append(self, slot, tokens):
        self._hist[slot].extend(tokens)

    def propose(self, slot, n, k):
        from mixq_tpu_torch.engine.speculative import propose_ngram

        return propose_ngram(self._hist[slot], n, k)


def make_drafter(n_slots: int) -> NativeDrafter:
    """The native drafter; a failed build raises."""
    return NativeDrafter(n_slots)
