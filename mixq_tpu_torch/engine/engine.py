"""Inference engine over a static KV cache (mirrors
mixq_tpu/engine/engine.py).

    prefill(tokens [B, Tp], cache, kv_start) -> (last logits, cache)
    decode_step(tokens [B, 1], cache, kv_start) -> (logits, cache)
    generate(prompts, ...) -> token lists
    warmup_online(batches) -> outlier counts (the online predictor's warmup)

Eager PyTorch: the cache is written in place. `generate` decodes, by
default (`EngineConfig.device_decode_loop`, as in JAX), through
`DecodeLoop`, the port of JAX's one-program device decode loop
(`_get_decode_loop`): one decode step that reads and writes only device
buffers (the forward, sampling, the EOS mask, the token and logprob
buffers), run on the card as replays of a CUDA graph of that step, with
the host reading the EOS mask only every DEFAULT_WINDOW steps; on the CPU
the same step runs eagerly with the same cadence. `device_decode_loop=False`
is the stepwise host loop (sample, read, next step). The head is widened
to f32 once, when the engine is built (`lm_head_f32`), not on every step.
The cache layout comes from JAX's policy (`use_head_major_cache` on
`specs.attn_impl`, the KV type and the cache length): head-major for
kernel 3, batch-major (a ring for a uniform sliding window) for kernel 8.
JAX's tail-window staging and flushes are not ported (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.engine.sampling import (SamplingParams, chosen_logprob,
                                            sample)
from mixq_tpu_torch.kernels.flash_decode import use_head_major_cache
from mixq_tpu_torch.models.decoder import (DecoderParams, DecoderSpecs,
                                           forward, lm_head_f32, writes_ring)
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.utils.shapes import round_up

_KV_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
# steps between two host reads of the EOS mask in `generate`: JAX's
# DEFAULT_TAIL_R, its loop's exit granularity on a tail cache
DEFAULT_WINDOW = 8


class DecodeLoop:
    """The device decode loop of one `generate` call (JAX's
    `_get_decode_loop`, mixq_tpu/engine/engine.py:120-183).

    It holds static buffers on the engine's device: the next input token
    `tok` [B, 1], the EOS mask `done` [B], the column counter `col` [1] and
    the output buffers `tokens` (and `lps`) [B, max_new_tokens], column 0
    the token sampled from the prefill. `step` is one decode step that
    reads and writes only these and the cache: the forward at the cache's
    device length, sampling, the EOS mask (rows already done emit eos) and
    the writes at column `col`. Nothing in it reads the device on the host.

    `run` runs the first step eagerly (on the card it is the capture's
    warm-up: it builds the kernel libraries and fills the plan, cluster
    and divisor caches), then on the card captures `step` as a CUDA graph
    (`capture`) and replays it (`replay`); on the CPU it calls `step`
    eagerly. Either way the host reads `done` only before the first step
    and every `window` steps after it. A graph holds the addresses of the
    cache, the parameters, the head and these buffers, so it is captured
    per loop, once per `generate` call. A capture or replay error
    raises. Replays skip `update_layer`'s host overflow check, so the
    loop refuses a cache (not a ring) too short for its steps.

    No graph may outlive the parameters it was captured on:
    `InferenceEngine.warmup_online` swaps `engine.params` for new tensors
    (promotion rebuilds them). Today each `generate` captures anew, so none
    does; a graph cached across calls must be dropped at such a swap."""

    def __init__(self, engine: "InferenceEngine", cache: KVCache,
                 kv_start: torch.Tensor, first_tok: torch.Tensor,
                 max_new_tokens: int, sampling: SamplingParams,
                 generator: Optional[torch.Generator],
                 eos_token_id: Optional[int] = None,
                 first_lp: Optional[torch.Tensor] = None):
        B = first_tok.shape[0]
        dev = engine.device
        if (not writes_ring(engine.model_cfg, cache)
                and cache.host_length + max_new_tokens - 1 > cache.max_seq):
            raise ValueError(
                f"cache overflow: {cache.host_length} + {max_new_tokens - 1}"
                f" decode steps > {cache.max_seq} slots")
        self.engine, self.cache, self.kv_start = engine, cache, kv_start
        self.sampling, self.generator = sampling, generator
        self.check_eos = eos_token_id is not None
        self.eos = eos_token_id if self.check_eos else -1
        self.tok = first_tok.reshape(B, 1).to(torch.int32).clone()
        self.done = first_tok == self.eos
        self.col = torch.ones((1,), dtype=torch.int64, device=dev)
        self.tokens = torch.zeros((B, max_new_tokens), dtype=torch.int32,
                                  device=dev)
        self.tokens[:, 0] = first_tok
        self.lps = None
        if first_lp is not None:
            self.lps = torch.zeros((B, max_new_tokens), dtype=torch.float32,
                                   device=dev)
            self.lps[:, 0] = first_lp
        self.graph = None
        self.logits = None          # the captured step's logits [B, V]

    @torch.inference_mode()
    def step(self) -> torch.Tensor:
        """One decode step on the buffers; returns its logits [B, V]."""
        eng = self.engine
        logits, _ = forward(eng.params, self.tok, self.cache, eng.specs,
                            eng.model_cfg, self.kv_start,
                            head_f32=eng.head_f32)
        last = logits[:, -1, :]
        tok = sample(last, self.generator, self.sampling)
        tok = torch.where(self.done, self.eos, tok)
        self.done |= tok == self.eos
        self.tokens.index_copy_(1, self.col, tok[:, None])
        if self.lps is not None:
            self.lps.index_copy_(1, self.col,
                                 chosen_logprob(last, tok)[:, None])
        self.tok.copy_(tok[:, None])
        self.col += 1
        return last

    @torch.inference_mode()
    def capture(self) -> None:
        """Capture `step` as a CUDA graph (torch.cuda.graph), after an
        eager step on the same buffers. The capture executes nothing: the
        length it added to the host mirror is taken back, and `replay`
        adds it once per replay. The wrappers count the launches the
        capture records, once."""
        graph = torch.cuda.CUDAGraph()
        if self.sampling.temperature > 0:
            graph.register_generator_state(self.generator)
        host_length = self.cache.host_length
        with torch.cuda.graph(graph):
            self.logits = self.step()
        self.cache.host_length = host_length
        self.graph = graph

    def replay(self, n: int = 1) -> None:
        """Replay the captured step n times."""
        for _ in range(n):
            self.graph.replay()
        self.cache.host_length += n

    def run(self, steps: int, window: int) -> None:
        """Run up to `steps` decode steps, stopping early, at a read of
        `done` (before the first step and every `window` steps after it),
        once every row is done."""
        on_card = self.cache.k.device.type == "cuda"
        ran = 0
        while ran < steps:
            if self.check_eos and bool(self.done.all()):
                break
            n = min(window, steps - ran)
            eager = n if not on_card else int(ran == 0)
            for _ in range(eager):
                self.step()
            if n > eager:
                if self.graph is None:
                    self.capture()
                self.replay(n - eager)
            ran += n


class InferenceEngine:
    """Single-device inference engine. `params` must already live on
    `device` (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        params: DecoderParams,
        model_cfg: ModelConfig,
        specs: DecoderSpecs,
        engine_cfg: Optional[EngineConfig] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"params live on {params.embed.device}, the "
                             f"engine on {self.device}")
        self.params = params
        self.model_cfg = model_cfg
        self.specs = specs
        self.engine_cfg = engine_cfg or EngineConfig()
        if self.engine_cfg.kv_dtype not in _KV_DTYPES:
            raise NotImplementedError(
                f"kv_dtype {self.engine_cfg.kv_dtype!r}: bfloat16 or int8")
        # the f32 head [H, V] that every forward's logits product reads
        # (4 bytes per element, held for the engine's life)
        self.head_f32 = lm_head_f32(params, specs)

    def new_cache(self, batch: int, max_seq: Optional[int] = None) -> KVCache:
        """A fresh cache in the layout the policy gives (JAX's new_cache
        without the tail staging)."""
        mc = self.model_cfg
        S = max_seq or self.engine_cfg.max_seq_len
        dtype = _KV_DTYPES[self.engine_cfg.kv_dtype]
        return KVCache.create(
            mc.num_hidden_layers, batch, S, mc.num_key_value_heads,
            mc.head_dim_, dtype=dtype,
            head_major=use_head_major_cache(self.specs.attn_impl, mc, S,
                                            dtype.itemsize),
            device=self.device)

    def warmup_online(self, warmup_batches, sigma: float = 6.0,
                      max_steps: int = 2, stats_log=None):
        """The online outlier predictor's warmup (JAX's warmup_online):
        detect outlier channels on the token batches, promote their weight
        rows to bf16, freeze, and swap the engine's params. The f32 head
        stays: no promotion touches the embedding or the head. Returns
        {"{layer}.{slot}": outlier count}; a `stats_log` list gets each
        warmup step's statistics."""
        from mixq_tpu_torch.quantize.online import warmup_online_outliers

        self.params, counts = warmup_online_outliers(
            self.params, self.model_cfg, self.specs, warmup_batches,
            sigma=sigma, max_steps=max_steps, head_f32=self.head_f32,
            stats_log=stats_log)
        return counts

    def _rows(self, x, B: int) -> torch.Tensor:
        if x is None:
            return torch.zeros((B,), dtype=torch.int32, device=self.device)
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    @torch.inference_mode()
    def prefill(self, tokens, cache: KVCache, kv_start=None):
        """Prefill a [B, Tp] token chunk (on a head-major cache, a fresh
        one); returns the last position's logits [B, V] and the cache."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, cache = forward(self.params, tokens, cache, self.specs,
                                self.model_cfg,
                                self._rows(kv_start, tokens.shape[0]),
                                head_f32=self.head_f32)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def decode_step(self, tokens, cache: KVCache, kv_start=None):
        """One decode step on [B, 1] tokens; returns logits [B, V]."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, cache = forward(self.params, tokens, cache, self.specs,
                                self.model_cfg,
                                self._rows(kv_start, tokens.shape[0]),
                                head_f32=self.head_f32)
        return logits[:, -1, :], cache

    @torch.inference_mode()
    def generate(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int = 128,
        sampling: SamplingParams = SamplingParams(),
        seed: int = 0,
        eos_token_id: Optional[int] = None,
        pad_token_id: int = 0,
        return_logprobs: bool = False,
    ):
        """Batched generation from token-id prompts, left-padded to a common
        length rounded up to `prefill_chunk`; per-row `kv_start` masks the
        padding. Rows stop at their first eos (and emit eos after it)."""
        B = len(prompts)
        if B == 0:
            raise ValueError("empty prompt batch")
        lens = [len(p) for p in prompts]
        if min(lens) == 0:
            raise ValueError("prompts must contain at least one token")
        Tp = min(round_up(max(lens), self.engine_cfg.prefill_chunk),
                 self.engine_cfg.max_seq_len)
        if max(lens) > Tp:
            raise ValueError("prompt longer than max_seq_len")
        tokens = np.full((B, Tp), pad_token_id, np.int32)
        kv_start = np.zeros((B,), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, Tp - len(p):] = p
            kv_start[i] = Tp - len(p)
        kv_start_t = self._rows(kv_start, B)

        cache = self.new_cache(B, round_up(Tp + max_new_tokens, 128))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        logits, cache = self.prefill(torch.from_numpy(tokens), cache,
                                     kv_start_t)
        tok = sample(logits, gen, sampling)
        first_lp = chosen_logprob(logits, tok) if return_logprobs else None
        if self.engine_cfg.device_decode_loop:
            loop = DecodeLoop(self, cache, kv_start_t, tok, max_new_tokens,
                              sampling, gen, eos_token_id, first_lp)
            loop.run(max_new_tokens - 1, DEFAULT_WINDOW)
            gen_toks, gen_lps = loop.tokens, loop.lps
        else:
            gen_toks, gen_lps = self._stepwise(
                tok, first_lp, cache, kv_start_t, max_new_tokens, sampling,
                gen, eos_token_id)
        gen_toks = gen_toks.cpu().numpy()
        if return_logprobs:
            gen_lps = gen_lps.cpu().numpy()
        results: List[List[int]] = []
        lp_results: List[List[float]] = []
        for i in range(B):
            row = gen_toks[i].tolist()
            if eos_token_id is not None and eos_token_id in row:
                row = row[: row.index(eos_token_id) + 1]
            results.append(row)
            if return_logprobs:
                lp_results.append(gen_lps[i, :len(row)].tolist())
        if return_logprobs:
            return results, lp_results
        return results

    def _stepwise(self, tok, first_lp, cache, kv_start, max_new_tokens,
                  sampling, gen, eos_token_id):
        """The host loop of device_decode_loop=False: each step's EOS mask
        is read on the host before the next. Returns the tokens [B, n] and
        logprobs [B, n] (or None), n <= max_new_tokens."""
        out_tokens, out_lps = [tok], [first_lp]
        done = (tok == eos_token_id if eos_token_id is not None else None)
        for _ in range(1, max_new_tokens):
            if done is not None and bool(done.all()):
                break
            logits, cache = self.decode_step(tok[:, None], cache, kv_start)
            tok = sample(logits, gen, sampling)
            if done is not None:
                tok = torch.where(done, eos_token_id, tok)
                done = done | (tok == eos_token_id)
            out_tokens.append(tok)
            if first_lp is not None:
                out_lps.append(chosen_logprob(logits, tok))
        return (torch.stack(out_tokens, dim=1),
                None if first_lp is None else torch.stack(out_lps, dim=1))
