"""Continuous batching: slot-based serving over a shared KV cache (mirrors
mixq_tpu/engine/batching.py, single device).

A fixed pool of `max_batch_size` KV-cache rows. Requests queue in the
native C++ scheduler (engine/scheduler.py); the prompts admitted together
share one batched [k_pad, Tp] prefill into a small cache, whose rows are
copied into their slots, one pass per cache buffer. Every decode step then
runs ONE T=1 forward over all slots at per-row positions
(`forward(..., slot_lengths=...)`); inactive slots compute tokens that are
ignored, so the step's shapes never change as requests come and go.

The decode step reads and writes only engine-owned device buffers: the
slots' lengths, current tokens and active mask (`_state`, written from
the host before each window or step, since admissions change them), the
per-slot sampling arrays, and the [R, n_slots] token and logprob outputs
at a column counter. `step_window` runs R steps with one host read: on the
card as replays of a CUDA graph of the step, captured once per engine and
sampling mode (all greedy, or some row sampling: the host knows every
slot's parameters) at the first window of that mode; on the CPU eagerly.
`step` runs the same step function eagerly, with a host read per token.
The step's own logic is JAX's `one_step`: sample, keep the old token
where a slot is inactive, lengths = min(lengths + active, S - 1) (the
clamp keeps a slot that finished mid-window inside the cache, and it is
what bounds the graph's KV writes, where no host check runs).

The pool takes its layout from the engine policy (`use_head_major_cache`):
batch-major (kernel 8) or head-major (kernel 3), written in place, so
JAX's token-major tail window and its flushes have no counterpart. A graph
holds the addresses of the parameters it was captured on: assigning
`engine.params` drops the graphs and widens the new head.

Admission keeps JAX's bucketing (k_pad a power of two, pad rows repeating
the last request; the insert copies only the k real rows, so no index of
its `index_copy_` repeats). A group that needs several prefill chunks
(`prefill_token_budget`) prefills into a batch-major small cache, whose
continuation chunks attend over it, and is transposed into a head-major
pool at the insert; `quantize_kv` is per (token, head), so the int8 bits
do not depend on the layout. (JAX's head-major continuation chunk attends
only over its own tokens: ROADMAP.md Queue C.)

Not ported here (each raises NotImplementedError naming its ROADMAP.md
item): snapshot/restore, warmup, speculative decoding (spec_k > 1),
async windows, meshes and pipeline stages.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.engine import engine as engine_mod
from mixq_tpu_torch.engine.sampling import (SamplingParams, chosen_logprob,
                                            sample_per_slot)
from mixq_tpu_torch.engine.scheduler import NativeScheduler
from mixq_tpu_torch.kernels.flash_decode import use_head_major_cache
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.utils.shapes import round_up

SERVING = "ROADMAP.md Queue A item 8"
PARALLELISM = "ROADMAP.md Queue A item 9"


def _not_ported(what: str, item: str = SERVING):
    raise NotImplementedError(f"ContinuousBatchingEngine: {what} is not "
                              f"ported ({item})")


class ContinuousBatchingEngine:
    def __init__(
        self,
        params: DecoderParams,
        model_cfg: ModelConfig,
        specs: DecoderSpecs,
        engine_cfg: Optional[EngineConfig] = None,
        mesh=None,
        device="cuda",
    ):
        """`params` must already live on `device` (the card unless the
        caller asks for the CPU)."""
        ecfg = engine_cfg or EngineConfig()
        if mesh is not None or ecfg.pipe_stages > 1:
            _not_ported("serving over a mesh or pipeline stages",
                        PARALLELISM)
        if ecfg.spec_k > 1:
            _not_ported("speculative decoding (spec_k > 1)")
        if ecfg.async_windows:
            _not_ported("async windows")
        kv_dtype = engine_mod._KV_DTYPES.get(ecfg.kv_dtype)
        if kv_dtype is None:
            raise NotImplementedError(
                f"kv_dtype {ecfg.kv_dtype!r}: bfloat16 or int8")
        self.device = torch.device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.ecfg, self.cfg, self.specs = ecfg, model_cfg, specs
        self._graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.params = params
        self.n_slots = n = ecfg.max_batch_size
        self.max_seq = S = ecfg.max_seq_len
        self.sched = NativeScheduler(n, S)
        mc = model_cfg
        self.cache = KVCache.create(
            mc.num_hidden_layers, n, S, mc.num_key_value_heads,
            mc.head_dim_, dtype=kv_dtype,
            head_major=use_head_major_cache(specs.attn_impl, mc, S,
                                            kv_dtype.itemsize),
            device=self.device)
        self._window_r = ecfg.window_r or engine_mod.DEFAULT_WINDOW
        # host state
        self.lengths = np.zeros((n,), np.int32)
        self.cur_tokens = np.zeros((n,), np.int32)
        self._prompts: Dict[int, List[int]] = {}
        self._req_sampling: Dict[int, Optional[SamplingParams]] = {}
        self._slot_sampling: Dict[int, Optional[SamplingParams]] = {}
        self._req_stop: Dict[int, frozenset] = {}
        self._slot_stop: Dict[int, frozenset] = {}
        self._outputs: Dict[int, List[int]] = {}
        self._logprobs: Dict[int, List[float]] = {}
        self._done: Dict[int, List[int]] = {}
        self._done_logprobs: Dict[int, List[float]] = {}
        self._slot_req: Dict[int, int] = {}
        self._next_id = 0
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        # the step's device buffers: lengths, current tokens, active mask
        dev = self.device
        self._state = torch.zeros((3, n), dtype=torch.int32, device=dev)
        self._temp = torch.zeros((n,), dtype=torch.float32, device=dev)
        self._topk = torch.zeros((n,), dtype=torch.int32, device=dev)
        self._topp = torch.ones((n,), dtype=torch.float32, device=dev)
        self._sampled = False         # some slot's temperature > 0
        R = self._window_r
        self._out_tok = torch.zeros((R, n), dtype=torch.int32, device=dev)
        self._out_lp = torch.zeros((R, n), dtype=torch.float32, device=dev)
        self._col = torch.zeros((1,), dtype=torch.int64, device=dev)

    @property
    def params(self) -> DecoderParams:
        return self._params

    @params.setter
    def params(self, value: DecoderParams) -> None:
        # a graph must not outlive the params it was captured on, and the
        # head (the embedding's transpose when tied) comes from them
        self._params = value
        self.head_f32 = lm_head_f32(value, self.specs)
        self._graphs.clear()

    # -- request API -------------------------------------------------------

    def add_request(self, prompt: Sequence[int], max_new_tokens: int,
                    sampling: Optional[SamplingParams] = None,
                    stop_token_ids: Optional[Sequence[int]] = None) -> int:
        """Queue a request; returns its id. `sampling`: its own sampling
        parameters (None: the step-level default). `stop_token_ids`: it
        finishes when it emits any of them (kept in the output, like
        EOS)."""
        rid = self._next_id
        self._next_id += 1
        rc = self.sched.add_request(rid, len(prompt), max_new_tokens)
        if rc != 0:
            raise ValueError(f"request rejected (code {rc}): "
                             f"prompt_len={len(prompt)} "
                             f"max_seq={self.max_seq}")
        self._prompts[rid] = list(prompt)
        self._req_sampling[rid] = sampling
        self._req_stop[rid] = (frozenset(stop_token_ids)
                               if stop_token_ids else frozenset())
        self._outputs[rid] = []
        self._logprobs[rid] = []
        return rid

    def finished(self) -> Dict[int, List[int]]:
        """Pop finished request outputs."""
        out, self._done = self._done, {}
        self._done_logprobs = {}
        return out

    def finished_records(self) -> Dict[int, Dict[str, list]]:
        """Pop finished requests with per-token logprobs: {rid: {"tokens":
        [...], "logprobs": [...]}} (log-softmax of the raw distribution at
        the chosen token)."""
        out, self._done = self._done, {}
        lps, self._done_logprobs = self._done_logprobs, {}
        return {r: {"tokens": t, "logprobs": lps.get(r, [])}
                for r, t in out.items()}

    @property
    def has_work(self) -> bool:
        s = self.sched.stats()
        return s["queued"] > 0 or s["active"] > 0

    def stats(self):
        return self.sched.stats()

    # -- not ported ----------------------------------------------------------

    def snapshot(self, path: str) -> None:
        _not_ported("snapshot")

    @classmethod
    def restore(cls, path: str, *args, **kwargs):
        _not_ported("restore")

    def warmup(self, *args, **kwargs):
        _not_ported("warmup")

    def step_spec(self, *args, **kwargs):
        _not_ported("step_spec (speculative decoding)")

    def step_spec_window(self, *args, **kwargs):
        _not_ported("step_spec_window (speculative decoding)")

    def step_serve(self, *args, **kwargs):
        _not_ported("step_serve (adaptive speculation)")

    def step_window_async(self, *args, **kwargs):
        _not_ported("step_window_async (async windows)")

    def drain_async(self, *args, **kwargs):
        _not_ported("drain_async (async windows)")

    # -- the decode step -----------------------------------------------------

    def _load_state(self, active: List[int],
                    default: SamplingParams) -> None:
        """Copy the host's lengths, current tokens and active mask into the
        step's buffers (one copy), and the per-slot sampling arrays: each
        slot carries its request's parameters, a free slot the default.
        Sets the step's mode: whether any slot samples."""
        act = np.zeros((self.n_slots,), np.int32)
        act[active] = 1
        self._state.copy_(torch.from_numpy(
            np.stack([self.lengths, self.cur_tokens, act])))
        t = np.full((self.n_slots,), default.temperature, np.float32)
        k = np.full((self.n_slots,), default.top_k, np.int32)
        p = np.full((self.n_slots,), default.top_p, np.float32)
        for slot, sp in self._slot_sampling.items():
            if sp is not None:
                t[slot], k[slot], p[slot] = sp.temperature, sp.top_k, sp.top_p
        for buf, arr in ((self._temp, t), (self._topk, k), (self._topp, p)):
            buf.copy_(torch.from_numpy(arr))
        self._sampled = bool((t > 0).any())

    def _step(self, sampled: bool) -> None:
        """One decode step over all slots on the device buffers: the
        forward at the slots' lengths, per-slot sampling, the token and
        logprob written at column `_col`, then JAX's one_step update.
        Nothing in it reads the device on the host."""
        lengths, tok, active = self._state[0], self._state[1], self._state[2]
        logits, _ = forward(self.params, tok[:, None], self.cache,
                            self.specs, self.cfg, head_f32=self.head_f32,
                            slot_lengths=lengths)
        last = logits[:, -1, :]
        t2 = sample_per_slot(last, self.generator, self._temp, self._topk,
                             self._topp, sampled)
        self._out_tok.index_copy_(0, self._col, t2[None])
        self._out_lp.index_copy_(0, self._col,
                                 chosen_logprob(last, t2)[None])
        tok.copy_(torch.where(active.bool(), t2, tok))
        lengths.copy_(torch.clamp_max(lengths + active, self.max_seq - 1))
        self._col += 1

    def _capture(self, sampled: bool) -> torch.cuda.CUDAGraph:
        """Capture `_step` in this mode as a CUDA graph (once per engine and
        mode; a sampling graph registers the generator). The capture runs
        nothing; the wrappers count the launches it records once."""
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            self._step(sampled)
        self._graphs[sampled] = graph
        return graph

    def _run_window(self) -> None:
        """R steps from column 0: on the card the mode's graph replayed R
        times (its first window runs one step eagerly, which builds the
        kernels and fills their plan caches, then captures and replays
        R - 1); on the CPU R eager steps."""
        self._col.zero_()
        sampled, n = self._sampled, self._window_r
        if self.device.type != "cuda":
            for _ in range(n):
                self._step(sampled)
            return
        graph = self._graphs.get(sampled)
        if graph is None:
            self._step(sampled)
            graph = self._capture(sampled)
            n -= 1
        for _ in range(n):
            graph.replay()

    # -- serving -------------------------------------------------------------

    def _admit(self, sampling: SamplingParams) -> List[int]:
        """Admit queued requests into free slots; load the step's buffers
        for the active slots, which are returned."""
        admits = self.sched.admit()
        if admits:
            self._admit_many(admits)
        active = self.sched.active_slots()
        if active:
            self._load_state(active, sampling)
        return active

    @torch.inference_mode()
    def step(self, sampling: SamplingParams = SamplingParams()) -> int:
        """Admit pending requests, then one decode step for all active
        slots, eagerly, with a host read of its tokens. Returns the number
        of active slots stepped."""
        active = self._admit(sampling)
        if not active:
            return 0
        self._col.zero_()
        self._step(self._sampled)
        self._process_window(self._out_tok[:1].cpu().numpy(),
                             self._out_lp[:1].cpu().numpy(), active,
                             {s: self._slot_req[s] for s in active}, None)
        return len(active)

    @torch.inference_mode()
    def step_window(self, sampling: SamplingParams = SamplingParams(),
                    eos_token_id: Optional[int] = None) -> int:
        """Admit pending requests, then a window of R decode steps on the
        device with one host read. Tokens a slot emits after it finishes
        (EOS, a stop token, its budget) inside the window are discarded;
        admissions happen only at window boundaries. Returns the number of
        slots that were active in the window."""
        active = self._admit(sampling)
        if not active:
            return 0
        rids = {s: self._slot_req[s] for s in active}
        self._run_window()
        self._process_window(self._out_tok.cpu().numpy(),
                             self._out_lp.cpu().numpy(), active, rids,
                             eos_token_id)
        return len(active)

    def _process_window(self, toks, lps, active, rids, eos_token_id) -> None:
        """Account one window's outputs ([R, n_slots] tokens and logprobs;
        a single step's are [1, n_slots]) step by step: a slot stops taking
        tokens at its budget, a stop token or EOS."""
        running = {s for s in active if self._slot_req.get(s) == rids[s]}
        for r in range(toks.shape[0]):
            if not running:
                break
            for slot in list(running):
                rid = self._slot_req[slot]
                tok = int(toks[r, slot])
                self._outputs[rid].append(tok)
                self._logprobs[rid].append(float(lps[r, slot]))
                self.lengths[slot] += 1
                self.cur_tokens[slot] = tok
                state = self.sched.on_token(slot)
                if state == 1:
                    self._finish_request(slot, rid)
                    running.discard(slot)
                elif (tok in self._slot_stop.get(slot, ())
                      or (eos_token_id is not None and tok == eos_token_id)):
                    self.finish_slot(slot)
                    running.discard(slot)

    def _finish_request(self, slot: int, rid: int) -> None:
        """Move a request's buffers to done and clear the slot (budget,
        EOS and stop finishes all come here)."""
        self._done[rid] = self._outputs.pop(rid)
        self._done_logprobs[rid] = self._logprobs.pop(rid, [])
        self._slot_req.pop(slot, None)
        self._slot_sampling.pop(slot, None)
        self._slot_stop.pop(slot, None)

    def finish_slot(self, slot: int) -> None:
        """Early-terminate (EOS) the request in `slot`."""
        rid = self._slot_req.get(slot)
        if rid is None:
            return
        self.sched.finish(slot)
        self._finish_request(slot, rid)

    def run_to_completion(
        self, sampling: SamplingParams = SamplingParams(),
        eos_token_id: Optional[int] = None, max_steps: int = 100000,
    ) -> Dict[int, List[int]]:
        """Drain the queue: windows (`device_decode_loop`, the default) or
        single steps until everything finishes."""
        results: Dict[int, List[int]] = {}
        steps = 0
        while self.has_work and steps < max_steps:
            if self.ecfg.device_decode_loop:
                self.step_window(sampling, eos_token_id=eos_token_id)
            else:
                self.step(sampling)
                if eos_token_id is not None:
                    for slot in list(self._slot_req):
                        rid = self._slot_req[slot]
                        if (self._outputs.get(rid)
                                and self._outputs[rid][-1] == eos_token_id):
                            self.finish_slot(slot)
            steps += 1
            results.update(self.finished())
        return results

    # -- admission -----------------------------------------------------------

    def _admit_many(self, admits) -> None:
        """Admit [(rid, slot), ...]: prefill positions 0..n-2 of each
        prompt into its slot (the first decode step replays the last prompt
        token and emits the first generated one). The multi-token prompts
        of one admission share one batched [k_pad, Tp] prefill (in
        continuation chunks of Tc when k_pad * Tp passes the prefill token
        budget) and one insert."""
        group = []
        for rid, slot in admits:
            prompt = self._prompts.pop(rid)
            if len(prompt) > 1:
                group.append((slot, prompt))
            self.lengths[slot] = len(prompt) - 1
            self.cur_tokens[slot] = prompt[-1]
            self._slot_req[slot] = rid
            self._slot_sampling[slot] = self._req_sampling.pop(rid, None)
            self._slot_stop[slot] = self._req_stop.pop(rid, frozenset())
        if not group:
            return
        # k padded to a power of two (pad rows repeat the last request), Tp
        # to a prefill_chunk multiple: JAX's program buckets
        k = len(group)
        k_pad = 1 << (k - 1).bit_length()
        rows = [group[min(i, k - 1)] for i in range(k_pad)]
        n_max = max(len(p) for _, p in group)
        Tp = min(round_up(max(n_max - 1, 1), self.ecfg.prefill_chunk),
                 self.max_seq)
        Tc, Tp_pad, small_seq = self._prefill_plan(k_pad, Tp)
        toks = np.zeros((k_pad, Tp_pad), np.int32)
        for i, (_, p) in enumerate(rows):
            toks[i, :len(p) - 1] = p[:-1]   # right-padded; positions past
                                            # n - 2 are overwritten by decode
        toks = torch.from_numpy(toks).to(self.device)
        mc = self.cfg
        # continuation chunks attend over the small cache: batch-major
        small = KVCache.create(
            mc.num_hidden_layers, k_pad, small_seq, mc.num_key_value_heads,
            mc.head_dim_, dtype=self.cache.k.dtype,
            head_major=self.cache.head_major and Tc == Tp_pad,
            device=self.device)
        for off in range(0, Tp_pad, Tc):
            forward(self.params, toks[:, off:off + Tc], small, self.specs,
                    mc, head_f32=None)
        self._insert(small, [s for s, _ in group], Tp)

    def _prefill_plan(self, k_pad: int, Tp: int):
        """(Tc, Tp_pad, small_seq): the chunk width under the prefill token
        budget, the prompt span padded to a Tc multiple, and the small
        cache's length (+ the window as ring slack for a uniform-window
        model on a batch-major pool) — JAX's _prefill_plan."""
        budget = self.ecfg.prefill_token_budget
        Tc = Tp
        if budget > 0 and k_pad * Tp > budget:
            q = self.ecfg.prefill_chunk
            Tc = min(max(q, (budget // k_pad) // q * q), Tp)
        Tp_pad = -(-Tp // Tc) * Tc
        ring = (self.cfg.sliding_window is not None
                and not self.cache.head_major
                and self.cfg.sliding_window_pattern == 1)
        return Tc, Tp_pad, Tp_pad + (self.cfg.sliding_window if ring else 0)

    def _insert(self, small: KVCache, slots: List[int], Tp: int) -> None:
        """Copy positions [0, Tp) of the small cache's first k rows into the
        pool's rows `slots` (k distinct slots), one index_copy_ per buffer;
        a batch-major small cache goes into a head-major pool transposed."""
        k = len(slots)
        idx = torch.tensor(slots, dtype=torch.int64, device=self.device)
        pool = self.cache
        if pool.head_major:
            axis, dst = 2, (lambda a: a[:, :, :, :Tp])
            if small.head_major:
                src = lambda a: a[:, :, :k, :Tp]          # noqa: E731
            else:      # [L, k, Tp, n_kv(, D)] -> [L, n_kv, k, Tp(, D)]
                src = lambda a: a[:, :k, :Tp].movedim(3, 1)  # noqa: E731
        else:
            axis, dst = 1, (lambda a: a[:, :, :Tp])
            src = lambda a: a[:, :k, :Tp]                  # noqa: E731
        pairs = [(pool.k, small.k), (pool.v, small.v)]
        if pool.quantized:
            pairs += [(pool.k_scale, small.k_scale),
                      (pool.v_scale, small.v_scale)]
        for big, sm in pairs:
            dst(big).index_copy_(axis, idx, src(sm))
