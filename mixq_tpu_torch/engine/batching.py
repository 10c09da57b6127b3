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

Speculative decoding (`spec_k` > 1; prompt-lookup n-grams,
engine/speculative.py): a verify is one T=spec_k forward over all slots,
greedy rows feeding [token, draft...] and emitting the accepted prefix + 1
(greedy decode's tokens), sampled rows emitting position 0's sample.
`step_spec` drafts on the host (the native drafter) and verifies eagerly;
`step_spec_window` runs `spec_window_r` rounds as replays of one captured
round (`_spec_round`: drafting on the device over an [n_slots, S] history,
the verify, acceptance, and the emission into [R, n_slots, spec_k]
outputs, the history, token and length updates), with one host read;
`step_serve` switches between spec and plain windows on the measured gain
(JAX's adaptive policy). The scheduler keeps spec_k - 1 positions in
reserve, and the spec round clamps lengths at S - spec_k, so a verify's
span stays inside the cache.

Async windows (`step_window_async`, JAX's lag-1 pipeline): window N+1's
replays are enqueued before window N's tokens are read; N's outputs are
copied on the stream, behind N's replays and before N+1's, into one of two
pinned host buffers, and read after an event. The carries (lengths,
tokens) stay in the device `_state`; `_load_state` then writes only the
slots that admission rewrote. Every synchronous entry point and
`snapshot` drain the in-flight window first. Host-to-device writes go
through pinned memory without a host sync, so the host never waits for
an in-flight window to write the next one's inputs.

`snapshot` / `restore` persist the pool (state.npz with the port's cache
layout, meta.json as JAX's), the generator's state standing for JAX's PRNG
key. `warmup` builds the kernels, runs each admission bucket once and
captures the window graphs, so that serving afterwards captures none.

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

Not ported here: meshes and pipeline stages (NotImplementedError naming
ROADMAP.md Queue A item 9).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.engine import engine as engine_mod
from mixq_tpu_torch.engine.sampling import (SamplingParams, chosen_logprob,
                                            sample_per_slot)
from mixq_tpu_torch.engine.scheduler import NativeDrafter, NativeScheduler
from mixq_tpu_torch.engine.speculative import (accept_greedy,
                                               propose_ngram_device)
from mixq_tpu_torch.kernels.flash_decode import use_head_major_cache
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32)
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.utils.shapes import round_up

_CACHE_FIELDS = ("k", "v", "k_scale", "v_scale")


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
            raise NotImplementedError(
                "ContinuousBatchingEngine: serving over a mesh or pipeline "
                "stages is not ported (ROADMAP.md Queue A item 9)")
        kv_dtype = engine_mod._KV_DTYPES.get(ecfg.kv_dtype)
        if kv_dtype is None:
            raise NotImplementedError(
                f"kv_dtype {ecfg.kv_dtype!r}: bfloat16 or int8")
        k = ecfg.spec_k
        if k > 1:
            # JAX's refusals (mixq_tpu/engine/batching.py:246-254)
            if model_cfg.sliding_window is not None:
                raise ValueError(
                    "spec_k > 1 does not support sliding-window models")
            if params.stacked is not None:
                raise ValueError(
                    "spec_k > 1 needs per-layer params (the stacked scan "
                    "body's slot write is T=1-shaped)")
        self.device = torch.device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.ecfg, self.cfg, self.specs = ecfg, model_cfg, specs
        # CUDA graphs by sampling mode: of `_step` (plain windows) and of
        # `_spec_round` (spec windows); `captures` counts every capture
        self._graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self._spec_graphs: Dict[bool, torch.cuda.CUDAGraph] = {}
        self.captures = 0
        self.params = params
        self.n_slots = n = ecfg.max_batch_size
        self.max_seq = S = ecfg.max_seq_len
        # a verify at length s writes s .. s + k - 1: spec engines keep
        # k - 1 positions in reserve (JAX's sched_seq)
        self.sched = NativeScheduler(n, S - (k - 1 if k > 1 else 0))
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
        self._req_budget: Dict[int, int] = {}
        self._req_sampling: Dict[int, Optional[SamplingParams]] = {}
        self._slot_sampling: Dict[int, Optional[SamplingParams]] = {}
        self._req_stop: Dict[int, frozenset] = {}
        self._slot_stop: Dict[int, frozenset] = {}
        self._outputs: Dict[int, List[int]] = {}
        self._logprobs: Dict[int, List[float]] = {}
        self._done: Dict[int, List[int]] = {}
        self._done_logprobs: Dict[int, List[float]] = {}
        self._slot_req: Dict[int, int] = {}
        self._slot_prompt: Dict[int, List[int]] = {}
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
        # speculation: the host drafter (step_spec), the device histories
        # (spec windows; column S is a sink for writes past the end) and
        # the spec window's [R, n_slots, k] outputs
        self.spec_stats = {"forwards": 0, "drafted": 0, "accepted": 0,
                           "emitted": 0}
        self._spec_mode = "spec"
        self._spec_gains: List[float] = []
        self._plain_since_probe = 0
        self._last_spec_gain = 1.0
        self._drafter = None
        if k > 1:
            Rs = ecfg.spec_window_r
            self._drafter = NativeDrafter(n)
            self._hist = torch.zeros((n, S + 1), dtype=torch.int32,
                                     device=dev)
            self._hlen = torch.zeros((n,), dtype=torch.int32, device=dev)
            self._spec_tok = torch.zeros((Rs, n, k), dtype=torch.int32,
                                         device=dev)
            self._spec_lp = torch.zeros((Rs, n, k), dtype=torch.float32,
                                        device=dev)
            self._spec_cnt = torch.zeros((Rs, n), dtype=torch.int32,
                                         device=dev)
            self._spec_dlen = torch.zeros((Rs, n), dtype=torch.int32,
                                          device=dev)
        # async windows: the window in flight (its host buffers, event,
        # dispatch-time active list and slot -> request map), whether
        # `_state` holds its device carry, the slots admission rewrote
        # since the last dispatch, the EOS it was dispatched under, and
        # two pinned host buffers for its outputs
        self._async_inflight = None
        self._async_live = False
        self._async_overrides: set = set()
        self._async_eos: Optional[int] = None
        self._async_host = None
        self._async_flip = 0

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
        self._spec_graphs.clear()

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
        self._req_budget[rid] = int(max_new_tokens)
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

    # -- device buffers ------------------------------------------------------

    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: on the card through pinned
        memory, without a host sync (stream-ordered behind the work
        already enqueued, which an in-flight window may still be
        running)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _load_state(self, active: List[int], default: SamplingParams,
                    overrides=None) -> None:
        """Write the host's lengths, current tokens and active mask into
        the step's buffers, and the per-slot sampling arrays: each slot
        carries its request's parameters, a free slot the default. Sets
        the step's mode: whether any slot samples. `overrides` (async
        windows, while `_state` holds the device carry): the lengths and
        tokens of only these slots are written."""
        act = np.zeros((self.n_slots,), np.int32)
        act[active] = 1
        if overrides is None:
            self._state.copy_(self._h2d(
                np.stack([self.lengths, self.cur_tokens, act])))
        else:
            self._state[2].copy_(self._h2d(act))
            if overrides:
                idx = np.array(sorted(overrides), np.int64)
                self._state[:2].index_copy_(1, self._h2d(idx), self._h2d(
                    np.stack([self.lengths[idx], self.cur_tokens[idx]])))
        t = np.full((self.n_slots,), default.temperature, np.float32)
        k = np.full((self.n_slots,), default.top_k, np.int32)
        p = np.full((self.n_slots,), default.top_p, np.float32)
        for slot, sp in self._slot_sampling.items():
            if sp is not None:
                t[slot], k[slot], p[slot] = sp.temperature, sp.top_k, sp.top_p
        for buf, arr in ((self._temp, t), (self._topk, k), (self._topp, p)):
            buf.copy_(self._h2d(arr))
        self._sampled = bool((t > 0).any())

    # -- the decode step and the spec round ----------------------------------

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

    def _verify(self, feed: torch.Tensor, sampled: bool):
        """The verify forward of feed [n_slots, k] at the slots' lengths:
        each position's greedy token and its logprob [n_slots, k] (the
        greedy rows' acceptance material), and position 0's per-slot
        sample and logprob [n_slots] (what a plain step would emit), as
        JAX's `_verify`."""
        logits, _ = forward(self.params, feed, self.cache, self.specs,
                            self.cfg, head_f32=self.head_f32,
                            slot_lengths=self._state[0])
        preds = torch.argmax(logits, dim=-1).to(torch.int32)
        lsm = torch.log_softmax(logits.float(), dim=-1)
        plp = torch.gather(lsm, -1, preds.long()[..., None])[..., 0]
        s_tok = sample_per_slot(logits[:, 0], self.generator, self._temp,
                                self._topk, self._topp, sampled)
        s_lp = torch.gather(lsm[:, 0], -1, s_tok.long()[:, None])[:, 0]
        return preds, plp, s_tok, s_lp

    def _spec_round(self, sampled: bool) -> None:
        """One round of a spec window on the device buffers (JAX's
        spec_window scan body): draft from the device histories, verify,
        accept, write the emitted tokens, their logprobs, counts and draft
        lengths at column `_col`, and advance the histories, tokens and
        lengths (clamped at S - k: the next verify's span stays inside the
        cache). Nothing in it reads the device on the host."""
        k, S = self.ecfg.spec_k, self.max_seq
        lengths, tok = self._state[0], self._state[1]
        active = self._state[2].bool()
        greedy = self._temp <= 0
        draft, dlen = propose_ngram_device(self._hist[:, :S], self._hlen,
                                           self.ecfg.spec_ngram, k - 1)
        dlen = torch.where(greedy & active, dlen, 0)
        noise = float(self.ecfg.spec_draft_noise)
        if noise > 0.0:
            # the acceptance-curve instrument: a corrupted draft token
            # still rides the verify, and the model's argmax rejects it
            flip = torch.rand(draft.shape, generator=self.generator,
                              device=self.device) < noise
            draft = torch.where(flip, (draft + 1) % self.cfg.vocab_size,
                                draft)
        feed = torch.cat([tok[:, None], draft], dim=1)
        preds, plp, s_tok, s_lp = self._verify(feed, sampled)
        a = accept_greedy(preds[:, :k - 1], draft, dlen)
        e = torch.where(active, torch.where(greedy, a + 1, 1), 0).to(
            torch.int32)
        emitted = torch.where(greedy[:, None], preds,
                              torch.cat([s_tok[:, None], preds[:, 1:]], 1))
        elp = torch.where(greedy[:, None], plp,
                          torch.cat([s_lp[:, None], plp[:, 1:]], 1))
        last = torch.gather(emitted, 1, (e - 1).clamp(0, k - 1).long()[:,
                                                                       None])
        tok.copy_(torch.where(e > 0, last[:, 0], tok))
        j = torch.arange(k, device=self.device)[None]
        pos = self._hlen.long()[:, None] + j
        self._hist.scatter_(1, torch.where((j < e[:, None]) & (pos < S),
                                           pos, S), emitted)
        self._hlen.copy_(torch.clamp_max(self._hlen + e, S))
        lengths.copy_(torch.clamp_max(lengths + e, S - k))
        for buf, val in ((self._spec_tok, emitted), (self._spec_lp, elp),
                         (self._spec_cnt, e), (self._spec_dlen, dlen)):
            buf.index_copy_(0, self._col, val[None])
        self._col += 1

    def _capture(self, sampled: bool, spec: bool = False
                 ) -> torch.cuda.CUDAGraph:
        """Capture `_step` (or `_spec_round`) in this mode as a CUDA graph
        (once per engine, kind and mode; a graph that draws registers the
        generator). The capture runs nothing; the wrappers count the
        launches it records once."""
        graph = torch.cuda.CUDAGraph()
        if sampled or (spec and self.ecfg.spec_draft_noise > 0):
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            (self._spec_round if spec else self._step)(sampled)
        (self._spec_graphs if spec else self._graphs)[sampled] = graph
        self.captures += 1
        return graph

    def _run_window(self, spec: bool = False) -> None:
        """A window from column 0, of R plain steps or spec_window_r spec
        rounds: on the card the mode's graph replayed (a mode's first
        window runs one step eagerly, which builds the kernels and fills
        their plan caches, then captures and replays the rest); on the CPU
        eager steps."""
        self._col.zero_()
        sampled = self._sampled
        n = self.ecfg.spec_window_r if spec else self._window_r
        fn = self._spec_round if spec else self._step
        if self.device.type != "cuda":
            for _ in range(n):
                fn(sampled)
            return
        graph = (self._spec_graphs if spec else self._graphs).get(sampled)
        if graph is None:
            fn(sampled)
            graph = self._capture(sampled, spec)
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
        self.drain_async()
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
        self.drain_async(eos_token_id)
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
        tokens at its budget, a stop token or EOS. `rids` is the slot ->
        request map at dispatch: a slot whose request finished or changed
        hands since then takes none of them."""
        running = {s for s in active if rids.get(s) is not None
                   and self._slot_req.get(s) == rids[s]}
        for r in range(toks.shape[0]):
            if not running:
                break
            for slot in list(running):
                if not self._take(slot, int(toks[r, slot]),
                                  float(lps[r, slot]), eos_token_id):
                    running.discard(slot)

    def _take(self, slot: int, tok: int, lp: float,
              eos_token_id: Optional[int]) -> bool:
        """Credit one token to the slot's request; False when that
        finished it (its budget, a stop token or EOS)."""
        rid = self._slot_req[slot]
        self._outputs[rid].append(tok)
        self._logprobs[rid].append(lp)
        self.lengths[slot] += 1
        self.cur_tokens[slot] = tok
        if self.sched.on_token(slot) == 1:
            self._finish_request(slot, rid)
            return False
        if (tok in self._slot_stop.get(slot, ())
                or (eos_token_id is not None and tok == eos_token_id)):
            self.finish_slot(slot)
            return False
        return True

    def _finish_request(self, slot: int, rid: int) -> None:
        """Move a request's buffers to done and clear the slot (budget,
        EOS and stop finishes all come here)."""
        self._done[rid] = self._outputs.pop(rid)
        self._done_logprobs[rid] = self._logprobs.pop(rid, [])
        self._slot_req.pop(slot, None)
        self._slot_prompt.pop(slot, None)
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
        """Drain the queue, as JAX's: a spec engine through `step_serve`,
        else async windows (`async_windows`), windows
        (`device_decode_loop`, the default) or single steps."""
        results: Dict[int, List[int]] = {}
        steps = 0
        ecfg = self.ecfg
        while self.has_work and steps < max_steps:
            if ecfg.spec_k > 1:
                self.step_serve(sampling, eos_token_id=eos_token_id)
            elif ecfg.device_decode_loop and ecfg.async_windows:
                self.step_window_async(sampling, eos_token_id=eos_token_id)
            elif ecfg.device_decode_loop:
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

    # -- speculative decoding ------------------------------------------------

    def _require_spec(self, what: str) -> None:
        if self.ecfg.spec_k <= 1:
            raise ValueError(f"{what} needs EngineConfig.spec_k > 1")

    @torch.inference_mode()
    def step_spec(self, sampling: SamplingParams = SamplingParams(),
                  eos_token_id: Optional[int] = None) -> int:
        """One speculative step: admit, then one T=spec_k verify over all
        slots, eagerly, with the drafts from the host drafter. Greedy
        slots emit the accepted prefix + 1; sampled slots and slots with
        no draft emit one token, as `step`. Returns the number of active
        slots."""
        self._require_spec("step_spec")
        k = self.ecfg.spec_k
        self.drain_async(eos_token_id)
        active = self._admit(sampling)
        if not active:
            return 0
        feed = np.zeros((self.n_slots, k), np.int32)
        feed[:, 0] = self.cur_tokens
        drafts: Dict[int, List[int]] = {}
        for slot in active:
            sp = self._slot_sampling.get(slot) or sampling
            if sp.temperature > 0.0:
                continue                     # sampled row: no draft
            draft = self._drafter.propose(slot, self.ecfg.spec_ngram, k - 1)
            if draft:
                feed[slot, 1:1 + len(draft)] = draft
                drafts[slot] = draft
        outs = self._verify(self._h2d(feed), self._sampled)
        preds, plp, s_tok, s_lp = (t.cpu().numpy() for t in outs)
        self.spec_stats["forwards"] += 1
        for slot in active:
            sp = self._slot_sampling.get(slot) or sampling
            draft = drafts.get(slot, [])
            if sp.temperature > 0.0:
                emitted = [(int(s_tok[slot]), float(s_lp[slot]))]
            else:
                a = 0
                while a < len(draft) and int(preds[slot, a]) == draft[a]:
                    a += 1
                emitted = [(int(preds[slot, j]), float(plp[slot, j]))
                           for j in range(a + 1)]
                self.spec_stats["drafted"] += len(draft)
                self.spec_stats["accepted"] += a
            self.spec_stats["emitted"] += len(emitted)
            kept = []
            for tok, lp in emitted:
                kept.append(tok)
                if not self._take(slot, tok, lp, eos_token_id):
                    break
            else:
                self._drafter.append(slot, kept)
        return len(active)

    @torch.inference_mode()
    def step_spec_window(self, sampling: SamplingParams = SamplingParams(),
                         eos_token_id: Optional[int] = None) -> int:
        """Admit, then spec_window_r spec rounds on the device (replays of
        one captured round) with one host read: the spec counterpart of
        step_window, with its discard-after-finish and boundary-admission
        semantics. Returns the number of slots active in the window."""
        self._require_spec("step_spec_window")
        self.drain_async(eos_token_id)
        active = self._admit(sampling)
        if not active:
            return 0
        R = self.ecfg.spec_window_r
        self._run_window(spec=True)
        toks, lps, cnts, dlens = (
            t.cpu().numpy() for t in (self._spec_tok, self._spec_lp,
                                      self._spec_cnt, self._spec_dlen))
        self.spec_stats["forwards"] += R
        # emitted tokens per verify and active row; 1.0 is plain decode's
        self._last_spec_gain = float(cnts.sum()) / max(R * len(active), 1)
        running = set(active)
        for r in range(R):
            if not running:
                break
            for slot in list(running):
                e = int(cnts[r, slot])
                sp = self._slot_sampling.get(slot) or sampling
                if sp.temperature <= 0.0:
                    self.spec_stats["drafted"] += int(dlens[r, slot])
                    self.spec_stats["accepted"] += max(e - 1, 0)
                self.spec_stats["emitted"] += e
                for j in range(e):
                    if not self._take(slot, int(toks[r, slot, j]),
                                      float(lps[r, slot, j]), eos_token_id):
                        running.discard(slot)
                        break
        return len(active)

    def _write_hist(self, rows: Dict[int, List[int]]) -> None:
        """Rewrite the device histories of the given slots ({slot:
        tokens}, the last S kept)."""
        if not rows:
            return
        S = self.max_seq
        slots = sorted(rows)
        hist = np.zeros((len(slots), S + 1), np.int32)
        hlen = np.zeros((len(slots),), np.int32)
        for i, slot in enumerate(slots):
            toks = rows[slot][-S:]
            hist[i, :len(toks)] = toks
            hlen[i] = len(toks)
        idx = self._h2d(np.array(slots, np.int64))
        self._hist.index_copy_(0, idx, self._h2d(hist))
        self._hlen.index_copy_(0, idx, self._h2d(hlen))

    def _resync_hist(self) -> None:
        """Rebuild the device histories from the host records (prompt and
        every emitted token of each slot): plain windows do not keep them,
        so a re-probe after plain windows resyncs first."""
        self._write_hist({slot: self._slot_prompt.get(slot, [])
                          + self._outputs.get(rid, [])
                          for slot, rid in self._slot_req.items()})

    def step_serve(self, sampling: SamplingParams = SamplingParams(),
                   eos_token_id: Optional[int] = None) -> int:
        """One adaptive serving step (JAX's): spec windows while their
        gain pays for the T=spec_k verify, plain windows when the mean
        gain of the last spec_probe_len spec windows falls below
        spec_min_gain (0.55 * (spec_k + 1) by default), with a resynced
        spec probe every spec_probe_every plain windows."""
        ecfg = self.ecfg
        if not (ecfg.spec_k > 1 and ecfg.device_decode_loop
                and ecfg.spec_adaptive):
            if ecfg.spec_k > 1:
                return (self.step_spec_window(sampling, eos_token_id)
                        if ecfg.device_decode_loop
                        else self.step_spec(sampling,
                                            eos_token_id=eos_token_id))
            return self.step_window(sampling, eos_token_id=eos_token_id)
        if self._spec_mode == "plain":
            self._plain_since_probe += 1
            if self._plain_since_probe >= ecfg.spec_probe_every:
                self._spec_mode = "spec"
                self._plain_since_probe = 0
                self._spec_gains.clear()
                with torch.inference_mode():
                    self._resync_hist()
            return self.step_window(sampling, eos_token_id=eos_token_id)
        n = self.step_spec_window(sampling, eos_token_id=eos_token_id)
        if n:
            self._spec_gains.append(self._last_spec_gain)
        if len(self._spec_gains) >= ecfg.spec_probe_len:
            window = self._spec_gains[-ecfg.spec_probe_len:]
            min_gain = (ecfg.spec_min_gain
                        if ecfg.spec_min_gain is not None
                        else 0.55 * (ecfg.spec_k + 1))
            if sum(window) / len(window) < min_gain:
                self._spec_mode = "plain"
            self._spec_gains.clear()
        return n

    # -- async windows -------------------------------------------------------

    @torch.inference_mode()
    def step_window_async(self, sampling: SamplingParams = SamplingParams(),
                          eos_token_id: Optional[int] = None) -> int:
        """Lag-1 pipelined step_window: dispatch window N+1 before reading
        window N's tokens, so the host's reading and bookkeeping overlap
        the card's window. The next window starts from the device carry
        in `_state`; only slots that admission rewrote take the host's
        lengths and tokens. A slot that finished in the in-flight window
        decodes one more window of discarded tokens (its active bit is
        stale), and tokens are credited through the slot -> request map
        taken at dispatch. Returns the number of slots dispatched."""
        admits = self.sched.admit()
        if admits:
            self._admit_many(admits)
            self._async_overrides.update(slot for _, slot in admits)
        active = self.sched.active_slots()
        if not active:
            self.drain_async(eos_token_id)
            return 0
        self._load_state(active, sampling, self._async_overrides
                         if self._async_live else None)
        self._async_overrides.clear()
        self._async_live = True
        rids = {s: self._slot_req.get(s) for s in active}
        self._run_window()
        prev, self._async_inflight = self._async_inflight, (
            self._stage_outputs(), list(active), rids)
        self._async_eos = eos_token_id
        if prev is not None:
            self._process_window_rec(prev, eos_token_id)
        return len(active)

    def _stage_outputs(self):
        """Enqueue the copy of this window's tokens and logprobs to the
        host: on the card into the next of two pinned buffers, behind the
        window's replays, with an event; returns (tokens, logprobs,
        event)."""
        if self.device.type != "cuda":
            return self._out_tok.clone(), self._out_lp.clone(), None
        if self._async_host is None:
            self._async_host = [
                (torch.empty(tuple(self._out_tok.shape), dtype=torch.int32,
                             pin_memory=True),
                 torch.empty(tuple(self._out_lp.shape),
                             dtype=torch.float32, pin_memory=True))
                for _ in range(2)]
        tok, lp = self._async_host[self._async_flip]
        self._async_flip ^= 1
        tok.copy_(self._out_tok, non_blocking=True)
        lp.copy_(self._out_lp, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return tok, lp, event

    def drain_async(self, eos_token_id: Optional[int] = None) -> None:
        """Process the in-flight window (if any), under the EOS it was
        dispatched with unless one is given, and drop the device carry:
        afterwards the host's lengths and tokens are exact for every
        running slot. Every synchronous entry point calls it first."""
        if eos_token_id is None:
            eos_token_id = self._async_eos
        prev, self._async_inflight = self._async_inflight, None
        self._async_live = False
        self._async_overrides.clear()
        if prev is not None:
            self._process_window_rec(prev, eos_token_id)

    def _process_window_rec(self, rec, eos_token_id) -> None:
        """Wait for a dispatched window's outputs and account them
        (`_process_window`, with the dispatch-time slot -> request map)."""
        (tok, lp, event), active, rids = rec
        if event is not None:
            event.synchronize()
        self._process_window(tok.numpy(), lp.numpy(), active, rids,
                             eos_token_id)

    # -- snapshot / restore / warmup -----------------------------------------

    @torch.inference_mode()
    def snapshot(self, path: str) -> None:
        """Persist the pool's serving state between windows (JAX's
        snapshot): the KV cache (the port's layout), the per-slot
        scheduler state, in-flight outputs, queued requests, the sampling
        parameters and the generator's state, into `path`/state.npz and
        `path`/meta.json. Drains async windows first."""
        self.drain_async()
        os.makedirs(path, exist_ok=True)
        arrays = {"lengths": self.lengths, "cur_tokens": self.cur_tokens,
                  "generator": self.generator.get_state().numpy()}
        if self.ecfg.spec_k > 1:
            arrays["hist"] = self._hist[:, :self.max_seq].cpu().numpy()
            arrays["hlen"] = self._hlen.cpu().numpy()
        for f in _CACHE_FIELDS:
            t = getattr(self.cache, f)
            if t is not None:
                # numpy has no bfloat16: its bits, as int16
                t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
                arrays[f"cache_{f}"] = t.cpu().numpy()
        np.savez(os.path.join(path, "state.npz"), **arrays)

        def sp(v):
            return None if v is None else dataclasses.asdict(v)

        active = []
        for slot in self.sched.active_slots():
            rid, plen, gen, mnt = map(int, self.sched.slot_info(slot))
            active.append({
                "slot": int(slot), "rid": rid, "prompt_len": plen,
                "generated": gen, "max_new": mnt,
                "outputs": [int(t) for t in self._outputs.get(rid, [])],
                "logprobs": [float(x) for x in self._logprobs.get(rid, [])],
                "sampling": sp(self._slot_sampling.get(slot)),
                "stop": sorted(self._slot_stop.get(slot, ())),
                "prompt": self._slot_prompt.get(slot),
            })
        queued = [{
            "rid": int(rid), "prompt": self._prompts[rid],
            "budget": self._req_budget.get(rid, self.max_seq),
            "sampling": sp(self._req_sampling.get(rid)),
            "stop": sorted(self._req_stop.get(rid, ())),
        } for rid in self._prompts]
        meta = {
            "active": active, "queued": queued, "next_id": self._next_id,
            "done": {str(k): v for k, v in self._done.items()},
            "done_logprobs": {str(k): v
                              for k, v in self._done_logprobs.items()},
            "spec_stats": self.spec_stats, "spec_mode": self._spec_mode,
            "n_slots": self.n_slots, "max_seq": self.max_seq,
            "kv_dtype": str(self.ecfg.kv_dtype),
            "head_major": self.cache.head_major,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def restore(cls, path: str, params: DecoderParams, model_cfg: ModelConfig,
                specs: DecoderSpecs, engine_cfg: Optional[EngineConfig] = None,
                mesh=None, device="cuda") -> "ContinuousBatchingEngine":
        """A new engine holding the state `snapshot` wrote into `path`. The
        engine configuration must match the snapshotting engine's (shapes
        and dtypes checked: ValueError); its graphs are captured afresh."""
        from mixq_tpu_torch.engine.sampling import SamplingParams as SP

        eng = cls(params, model_cfg, specs, engine_cfg, mesh=mesh,
                  device=device)
        data = np.load(os.path.join(path, "state.npz"))
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if (meta["n_slots"], meta["max_seq"], meta["head_major"]) != (
                eng.n_slots, eng.max_seq, eng.cache.head_major):
            raise ValueError("engine config mismatch: the snapshot's pool is "
                             f"{meta['n_slots']} x {meta['max_seq']}, "
                             f"head_major={meta['head_major']}")
        for f in _CACHE_FIELDS:
            t = getattr(eng.cache, f)
            if t is None:
                continue
            a = data[f"cache_{f}"]
            if (a.shape != tuple(t.shape)
                    or a.dtype.itemsize != t.element_size()):
                raise ValueError(f"cache field {f}: snapshot {a.shape}/"
                                 f"{a.dtype} vs engine {tuple(t.shape)}/"
                                 f"{t.dtype}")
            src = torch.from_numpy(a)
            t.copy_(src.view(torch.bfloat16) if t.dtype == torch.bfloat16
                    else src)
        eng.lengths = data["lengths"].copy()
        eng.cur_tokens = data["cur_tokens"].copy()
        eng.generator.set_state(torch.from_numpy(data["generator"].copy()))
        hist = None
        if eng.ecfg.spec_k > 1 and "hist" in data:
            hist, hlen = data["hist"], data["hlen"]
            eng._hist[:, :eng.max_seq].copy_(torch.from_numpy(hist))
            eng._hlen.copy_(torch.from_numpy(hlen))

        def unsp(d):
            return None if d is None else SP(**d)

        for s in meta["active"]:
            slot, rid = s["slot"], s["rid"]
            rc = eng.sched.restore_slot(slot, rid, s["prompt_len"],
                                        s["max_new"], s["generated"])
            if rc != 0:
                raise ValueError(f"restore_slot({slot}) -> {rc}")
            eng._slot_req[slot] = rid
            eng._outputs[rid] = list(s["outputs"])
            eng._logprobs[rid] = list(s["logprobs"])
            eng._slot_sampling[slot] = unsp(s["sampling"])
            eng._slot_stop[slot] = frozenset(s["stop"])
            if s["prompt"] is not None:
                eng._slot_prompt[slot] = list(s["prompt"])
            if hist is not None:
                eng._drafter.reset(slot, hist[slot, :hlen[slot]].tolist())
        for q in meta["queued"]:
            eng._next_id = q["rid"]        # the original request ids
            eng.add_request(q["prompt"], q["budget"],
                            sampling=unsp(q["sampling"]),
                            stop_token_ids=q["stop"] or None)
        eng._next_id = meta["next_id"]
        eng._done = {int(k): v for k, v in meta["done"].items()}
        eng._done_logprobs = {int(k): v
                              for k, v in meta["done_logprobs"].items()}
        eng.spec_stats = meta["spec_stats"]
        eng._spec_mode = meta["spec_mode"]
        return eng

    @torch.inference_mode()
    def warmup(self, prompt_buckets: Optional[Sequence[int]] = None,
               group_sizes: Optional[Sequence[int]] = None,
               analyze: bool = False) -> int:
        """Prepare the serving programs on an idle pool, the port's
        counterpart of JAX's ahead-of-time compiles: build the kernel
        libraries, run each admission prefill plan (k_pad, Tc) of the
        buckets once eagerly, so the kernels' plan caches fill, and on the
        card capture the plain window's graph for each sampling mode, and
        the spec window's when spec_k > 1, so that serving afterwards
        captures none. Buckets as JAX's: prefill_chunk multiples up to
        max_seq (and max_seq), group sizes the powers of two up to the
        pool. Returns the number of programs (prefill plans and graphs).
        analyze=True prints each one's allocator peak to stderr (JAX's
        memory_analysis)."""
        if self.sched.stats()["active"]:
            raise RuntimeError("warmup runs on a pool with no active slot")
        self.drain_async()
        on_card = self.device.type == "cuda"
        if on_card:
            from mixq_tpu_torch.kernels import _build

            _build.build_all()
        if prompt_buckets is None:
            chunk = self.ecfg.prefill_chunk
            prompt_buckets = list(range(chunk, self.max_seq + 1, chunk))
            if not prompt_buckets or prompt_buckets[-1] != self.max_seq:
                prompt_buckets.append(self.max_seq)
        if group_sizes is None:
            group_sizes = ([1 << i for i in range(
                math.ceil(math.log2(self.n_slots)) + 1)]
                if self.n_slots > 1 else [1])
        mc, n = self.cfg, 0

        def probe(name, fn):
            if analyze and on_card:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            fn()
            if analyze and on_card:
                torch.cuda.synchronize()
                print(f"# memprobe {name}: peak allocated "
                      f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f}G",
                      file=sys.stderr)

        plans = set()
        for Tp in prompt_buckets:
            for k in group_sizes:
                Tc, Tp_pad, small_seq = self._prefill_plan(k, Tp)
                if (k, Tc, small_seq) in plans:
                    continue
                plans.add((k, Tc, small_seq))
                small = KVCache.create(
                    mc.num_hidden_layers, k, small_seq,
                    mc.num_key_value_heads, mc.head_dim_,
                    dtype=self.cache.k.dtype,
                    head_major=self.cache.head_major and Tc == Tp_pad,
                    device=self.device)
                toks = torch.zeros((k, Tc), dtype=torch.int32,
                                   device=self.device)
                probe(f"prefill[k={k},Tc={Tc}]",
                      lambda: forward(self.params, toks, small, self.specs,
                                      mc, head_f32=None))
                del small
                n += 1
        if on_card:
            # an eager step before each capture (kernels built, plan caches
            # filled) on an idle pool; the generator is put back, so a
            # warmed engine draws what an unwarmed one does
            rng = self.generator.get_state()
            self._state.zero_()
            kinds = [False] + ([True] if self.ecfg.spec_k > 1 else [])
            for spec in kinds:
                fn = self._spec_round if spec else self._step
                for sampled in (False, True):
                    if (self._spec_graphs if spec else self._graphs).get(
                            sampled) is not None:
                        continue
                    self._col.zero_()
                    fn(sampled)
                    probe(f"{'spec_window' if spec else 'window'}"
                          f"[sampled={sampled}]",
                          lambda: self._capture(sampled, spec))
                    n += 1
            self._state.zero_()
            if self.ecfg.spec_k > 1:
                self._hist.zero_()
                self._hlen.zero_()
            self.generator.set_state(rng)
        return n

    # -- admission -----------------------------------------------------------

    def _admit_many(self, admits) -> None:
        """Admit [(rid, slot), ...]: prefill positions 0..n-2 of each
        prompt into its slot (the first decode step replays the last prompt
        token and emits the first generated one). The multi-token prompts
        of one admission share one batched [k_pad, Tp] prefill (in
        continuation chunks of Tc when k_pad * Tp passes the prefill token
        budget) and one insert. A spec engine also restarts the slots'
        drafting histories at their prompts."""
        group, hist = [], {}
        for rid, slot in admits:
            prompt = self._prompts.pop(rid)
            self._req_budget.pop(rid, None)
            if len(prompt) > 1:
                group.append((slot, prompt))
            self.lengths[slot] = len(prompt) - 1
            self.cur_tokens[slot] = prompt[-1]
            self._slot_req[slot] = rid
            self._slot_sampling[slot] = self._req_sampling.pop(rid, None)
            self._slot_stop[slot] = self._req_stop.pop(rid, frozenset())
            if self._drafter is not None:
                self._drafter.reset(slot, prompt)
                self._slot_prompt[slot] = list(prompt)
                hist[slot] = prompt
        if hist:
            self._write_hist(hist)
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
        toks = self._h2d(toks)
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
        idx = self._h2d(np.array(slots, np.int64))
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
