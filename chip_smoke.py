#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mixq_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which fails the run (non-zero exit) when it fails:
  1. card: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: the five CUDA kernel libraries from mixq_tpu_torch/csrc, timed,
     with each instantiation's registers and spills (ptxas) of the
     int8-activation GEMM (kernels 2 and A; the four MIX instantiations
     held at their registers from before QUIK's zero-point mode, and the
     two zero-point ones), of flash decode and of
     decode attention (16 instantiations each, g x int8 x softcap), of
     kernel 1's register kernel (512 threads of one chunk, 256 of two; a
     spill in any of these fails) and of kernel B, and the clusters of 1..8
     blocks the card holds at once (kernels 3 and 8 at the served heads);
  3. kernels: each kernel, in each mode the main paths run, at Llama-2-7B
     main-path shapes against its plain PyTorch version on the same inputs,
     with the stated tolerance, then its device time on the card (CUPTI,
     through torch.profiler) beside its bound (bytes over 3.35 TB/s or
     operations over the data-sheet peak, whichever is larger), its plain
     version's and, where one exists, that of one PyTorch call computing
     the same function (`library_ms`): fused RMSNorm + quantization (kernel
     1; A8 and A4 at M=64 and M=8, A8 at M=512 and at phase 9's largest
     admission prefill, M=4096, at Llama-2-7B's and Gemma-2-9B's widths;
     q_x, x_scale and x_out also held bit-equal to the plain quantizer and
     gather fed the kernel's own y; each row timed at each instantiation
     that takes it, beside a trivial launch and the parent tree's time, not
     measured in the run), the int8 GEMM in its W8A8 (kernel 2) and its
     packed-W4 and grouped modes (kernel A), each row with its split-K
     plan and beside the earlier 64 x 32-tile kernel's time (not measured
     in the run), and as whole blocks (W8A8, W4, W4 g128, and the g128
     path's seven); a prefill-shaped W8A8 row at M=512, and every linear
     shape of the block in W8A8 at M=4096 (phase 9's largest admission
     prefill: 16 prompts of 256 tokens); three plans held bit-equal in
     W8A8 and in W4; the a16 (weight-only) GEMM with int8 and packed
     weights, per-channel and grouped, with the w8a16_matmul and
     int8_matmul_dequant entry points (each a16 row with its split-K plan,
     the clusters the card holds and ptxas's registers and spills; two
     split-K launches held bit-equal), and flash decode (each row with its
     cluster plan, R and blocks, the clusters of R blocks the card holds,
     its instantiation's load pipeline, registers and spills, two launches
     of the plan held bit-equal, and the parent tree's time, not measured
     in the run); then Gemma-2-9B's:
     every linear shape of its block in kernel 2 (W8A8), kernel A (W4 on
     q/k/v/up/gate) and kernel B (W8A16), with the tanh-GELU (gelu_new)
     epilogue on the gate, and the gate once with the exact GELU (no serve
     path runs it yet); flash decode with the logit softcap at its decode
     shape, int8 and bf16 KV, with a spread and a peaked softmax, and with
     Gemma-2-27B's score scale, and at generate's batch (B=8), where its
     rows split over clusters, at each cluster size; and decode attention
     over the batch-major cache (kernel 8) at Mistral-7B's heads (int8,
     spread and peaked), at Llama-2-7B's (bf16, beside SDPA), on Mistral's
     4096-slot ring read past its wrap, and at Gemma-2-9B's with the
     softcap (also held to the plain version on a CPU copy of its inputs),
     each row with its cluster plan (R, blocks, the clusters of R the card
     holds, its load pipeline, registers and spills), two launches of the
     plan held bit-equal, and the parent tree's time (not measured in the
     run); and at generate's batch (B=8) at Mistral's and Llama's heads,
     each held to its limit and timed at every cluster size; then kernel
     8's Mistral row beside kernel 3's GQA 32/8 int8 row (the same heads and
     bytes in the head-major layout); then Baichuan-13B's: kernel 1 at
     M=64 H=5120 A8 (its looping kernel), kernel 2 on each linear shape of
     its block and on the block of seven, kernel 3 with ALiBi at B=64
     S=512 40/40 D=128, int8 and bf16 KV (rows held in probability levels,
     at every cluster size R; bf16 beside SDPA with the bias as a float
     mask), and kernel 8 with ALiBi at the same heads, bf16 and int8 KV, at
     B=64 and at generate's B=8 (every R), each also against the plain
     version without the bias, which lies beyond its limit; then phase 9's
     pool rows: kernel 3 (int8, head-major) and kernel 8 (bf16, batch-
     major) at B=64 S=640 32/32 D=128 with lengths 1 to 640, a row at 1
     and one at S in one launch, no kv_start, held and timed at every R;
     then phase 10's prefill shapes (kernel_eval_shapes): kernel 1 at
     the tiny gate's M=1024 H=256 (A8, A4) and the 7B gate's M=2048 (A8,
     A4) and M=8192 (A8), kernels 2 and A on the tiny gate's linears
     (K, N of 256, 704) at M=1024 in W8A8, W4, and W4 and W8A8 with
     64-row groups (K=704: 11 groups), and on the Llama-2-7B block's at
     M=2048 (W8A8, W4) and M=8192 (W8A8); then phase 11's verify shapes
     (kernel_verify_shapes): kernel 1 at M=256 H=4096 A8, kernel 2 on
     every linear shape of the Llama-2-7B block at M=256 (64 slots x 4
     verify tokens), kernel 3 at the verify's per-row lengths (B=64 S=640
     32/32 int8, lengths 4 to 640); then QUIK's zero-point modes of
     kernels 2 and A (kernel_quik): asymmetric activations that reach
     -8 (A4) and -128 (A8) with a row of zeros, 256 outlier channels in
     two chunks, each distinct linear shape of the Llama-2-7B QUIK block
     at M=64 (q/k/v, up, gate+SiLU W4; o, down W8), its five W4 linears,
     its two W8 ones and its seven at M=64, M=8 and M=2,048 (phase 10's
     window batch), beside torch._int_mm with the epilogue in torch ops,
     and the bits held across forced splits S = 1..8 in both modes;
  4. reference: tiny W8A8, W4A4 (per-channel and grouped) and W8A16 llama
     models, and tiny W8A8, W4A4 and W8A16 gemma2 models (caps that bind
     without saturating), on the head-major cache (attn_impl="flash"); a
     tiny W8A8 llama on the batch-major cache and a tiny W8A8 mistral on an
     8-slot ring that wraps twice (attn_impl="auto"); a tiny W8A8 ALiBi
     llama-shaped model (6 heads: slopes of a head count that is not a
     power of two; rope style "none") under "flash" and under "auto"; each
     on the card against the same model on the CPU (the plain versions),
     teacher-forced
     logits, bf16 and int8 KV, each limit below the int8-vs-bf16 KV
     control; every flash decode and decode attention launch against its
     plain version on the model's own inputs, where the card first leaves
     the CPU, and launch counts by mode; and the tiny W8A8 llama served by
     the continuous-batching engine (10 requests on 4 slots, int8 KV,
     "flash" and "auto") on the card and on the CPU: each request replayed
     teacher-forced within the layout's logits limit, and the same tokens
     up to its first step whose top-2 margin is not above twice its
     card-vs-CPU gap;
  5. serve: full-width 32-layer Llama-2-7B in four configurations,
     full-width Gemma-2-9B at 21 of its 42 layers (a depth cut for the
     time limit) in three, full-width 32-layer Mistral-7B-v0.1 W8A8O16,
     Llama-2-7B W8A8O16 with bf16 KV and Llama-2-7B QUIK W4A4 (256 outlier
     channels per linear input; kernels 2 and A in their zero-point modes,
     no kernel 1), one after
     another (each freed before the next is built): Llama W8A8O16, and from
     the reference policy (quantize.resolve_specs) W4A4O16 per-channel,
     W4A4O16 with 128-row scale groups, and W8A16; Gemma-2-9B W8A8O16,
     W4A4O16 and W8A16 (all on the head-major cache with int8 KV, kernel
     3); Mistral (int8 KV) and Llama bf16 KV under the default
     attn_impl="auto", which puts them on the batch-major cache (Mistral's
     a ring), kernel 8; random weights from a seed, 128 outlier channels
     per MIX linear input, 8 left-padded prompts, 32 greedy tokens through
     InferenceEngine.generate, its default device decode loop: one eager
     step, then the step's CUDA graph captured once and replayed 30 times
     (counted), under torch.profiler: the kernels the card ran, by name
     (kernels.executed_counts), asserted by mode against one prefill and
     31 decode steps, and the wrappers' launch counts (set to 0 just
     before each generate, read just after: the prefill, the eager step
     and the captured one) asserted by mode; the tokens held equal to the
     same generate unprofiled (timed) and to a stepwise generate
     (device_decode_loop=False) on the same engine;
  6. timing: for Llama-2-7B W8A8O16, Mistral-7B W8A8O16 and Llama-2-7B
     QUIK W4A4 only (a cut for the time limit) the device loop's decode
     step at batch
     64 with the KV cache filled to 512 positions, eagerly and as replays
     of its CUDA graph, each run from the same state: one eager step's
     launch counts by mode (asserted) under
     torch.cuda.set_sync_debug_mode("error"); 8 replays' logits and tokens
     held bit-equal to 8 eager steps'; the capture's host time; 8 steps
     timed eager, graph, graph, eager (wall ms/step, CUDA-event ms/step,
     tok/s); peak device memory, the memory of the f32 head the engine
     holds, the step's byte bound from the model's tensors, and over 8
     more steps of each under torch.profiler (device activity only) the
     kernels the card ran by name (asserted: 8 steps' worth), the device
     time per step, its attention kernels' (kernel 3 or 8) device time per
     step (kernel 8's beside the parent tree's, not measured in the run),
     the device's busy share (device time over the wall time of that same
     window, asserted <= 1) and the top kernels; for Mistral also
     one step at batch 16 on a window-sized (4096-slot) ring filled past
     its wrap, every kernel-8 launch held against its plain version; for
     QUIK also 2 eager steps profiled with host ranges, their device ms
     split into kernel A, kernel 2, kernel 3 and the asymmetric-quant glue
     (quik_step_split); and
     one prefill of 8 prompts x 64 tokens into a fresh cache (512 rows
     through every linear), its device ms and wall ms;
  7. pipeline: full-width 32-layer Llama-2-7B from float weights to served
     tokens. A seeded bf16 state dict under HF names on the card (4
     embedding channels boosted by 1000, PLANTED), quantize_model(W8A8:
     empty outlier sets), InferenceEngine.warmup_online on two batches of
     8 x 64 tokens, then phase 5's generate and phase 6's decode timing on
     the warmed model (its device ms beside phase 6's random-init W8A8O16
     row); every planted channel in every wqkv and up set, counts within
     the budget, each set equal to the plain rule run on the card's own
     stats, the planted channels' margin over sigma reported (asserted >
     2); the first 2 layers quantized and warmed on the card and on the
     CPU (params bit-equal, counts equal, sets equal wherever a channel's
     max clears sigma by more than the two devices' stats differ). The
     dict goes through disk: after a check of the temp directory's free
     space (at least 22 GB, else the run fails), it is written with the
     port's safetensors writer as an HF directory (shards of at most 5 GB,
     model.safetensors.index.json, config.json of Llama-2-7B's fields) and
     AutoModel.from_pretrained(W8A8) of it is held bit-equal to
     quantize_model of the dict in memory; the warmed W8A8O16 params go
     through save_checkpoint and AutoModel.from_quantized (every tensor
     bit-equal; phase 9 serves the loaded params), and generate_torch.py
     on that checkpoint, in a subprocess on the card, gives the in-process
     generate's greedy tokens; then AutoModel.from_pretrained(W4A4,
     calib_batches: calibration on the card) reads the directory again,
     phase 5's generate serves it, and its params through a checkpoint
     serve the same greedy tokens through kernel A; and so does
     AutoModel.from_pretrained(QUIK W4A4, calib_batches) of the same
     directory (sets of 256 equal to the calibration run's top channels;
     served by generate through the zero-point modes, no kernel 1; its
     checkpoint bit-equal and serving the same greedy tokens). It prints
     the host seconds of the float dict, quantize_model, calibration and
     warmup_online, the counts by slot, the bytes,
     host seconds and GB/s of each write and each read (warm: the files
     were just written), the card's peak memory while each load ran, the
     files read, and the phase's peak memory. Every directory is deleted
     when it is no longer needed, and the phase's in a `finally`;
  8. Baichuan: full-width Baichuan-13B at 20 of its 40 layers (a depth
     cut for the time limit; ALiBi, 40 heads) from a
     seeded bf16 state dict under Baichuan's HF names (q, k and v as one
     W_pack tensor; phase 7's planted embedding) through
     quantize_model(W8A8: empty sets) and warmup_online (two batches of 8 x
     64 tokens; sets equal to the plain rule on the card's own stats); the
     first 2 layers quantized and warmed on the card and on the CPU as in
     phase 7; the dict freed, then the warmed params served under "auto"
     (batch-major bf16 KV: kernel 8 with ALiBi) and under "flash" (head-
     major int8 KV: kernel 3 with ALiBi), each through phase 5's generate,
     and under "auto" phase 6's decode timing (a cut for the time
     limit). It prints the host seconds of the dict, quantize_model and
     warmup_online, the counts by slot, the planted channels' margins and
     the phase's peak memory.
  9. continuous batching (run after phase 7, whose warmed Llama-2-7B
     W8A8O16 params it serves as loaded from their checkpoint, and before
     phase 8): the CB engine
     (engine/batching.py, the native scheduler) on a pool of 64 slots x 640
     positions under "auto" with bf16 KV (batch-major, kernel 8) and under
     "flash" with int8 KV (head-major, kernel 3). A seeded script of 192
     requests (prompts of 16-256 tokens, budgets of 16-128; at most 16
     arrive a window; 8 sample at temperature 0.8, top-k 50, top-p 0.9; 4
     carry a stop set, each the 4th greedy token of its prompt served
     alone first) through step_window (windows of 8 steps as CUDA graph
     replays), the wrappers' counts set to 0 just before and read just
     after, then through single eager steps on the same engine. It prints
     for each pool the requests, tokens, windows, wall s and tokens/s, ms
     per window (median, p90), one window's CUPTI device ms per step by
     kernel name and busy share (windows profiled one by one until one
     holds every kernel run its steps imply), the admissions' ms, the
     captures' ms and the peak memory; and asserts that every request ends
     at its budget or its stop token, the greedy requests' tokens equal
     between windows and single steps, the slot-mode forward's logits at
     one length for every row bit-equal to the scalar-length forward's,
     a full-pool verify of 4 tokens a row at ragged lengths against 4 T=1
     slot steps on the same cache (verify_vs_steps: layer 0's attention
     within a bf16 ulp, the bf16 pool's steps through kernel 8's plain
     version; the 32-layer logits' argmaxes equal clear of near-ties, on
     the int8 pool within 1e-5 of their max; the verify one position late
     rejected), the native scheduler in use, and no admission prefill past
     the rows (M=4096) at which phase 3 held kernels 1 and 2.
 10. evaluation (run last), the wrappers' counts set to 0 just before and
     read just after: examples/realistic_gate_torch.run with JAX's
     defaults (a tiny LM trained on the card for 600 steps, planted
     outlier channels, the online predictor's warmup, PPL of fp16, mix8,
     mix4, mix4_g64, mix4_full_g64, quik and the warmed mix8 on 4 held-out
     segments with bf16 and int8 KV; asserted: the loss below 0.75 ln V,
     the planting's drift below 0.02, all 6 planted channels in every
     layer's q/k/v set), each config's first segment also on a CPU copy
     of its params (the plain versions), the card within the larger of
     the CPU's int8-vs-bf16 KV gap and 1e-3 of its PPL (2.5e-3 for the A4
     configs and quik, held under a control: one linear's outlier term
     dropped; ppl_card_vs_cpu); then
     examples/gate_7b_torch.run at Llama-2-7B's full width and depth
     (FP16, mix8, mix4 and quik on the Markov substrate at margin 7, 4 chain
     segments x 8 windows x 256, bf16 and int8 KV; asserted: FP16's PPL
     within 5% of its chain's, 1 + (V - 1) e^-margin), with a 2-layer
     full-width copy of mix8, mix4 and quik held on the card against the
     CPU as above, one window batch of mix8, mix4 and quik (and of the tiny
     mix4_g64 and mix4_full_g64: kernel A's new shapes) profiled, its
     device ms split into kernel 1, kernels 2 and A, the f32 prefill
     attention, QUIK's activation glue and the rest, 32 mix8 windows
     timed at batch 8 and 32,
     and the offline cloze and completion tasks through MixQLM on FP16
     (the control) and mix8 (asserted: acc and exact_match >= 0.9 on
     mix8, kernel 8 run in its decode steps, counted by name). It prints
     the rows, the host seconds, evaluated tokens/s and the peak memory.
 11. speculative serving (run last): the Markov Llama-2-7B of
     benchserve.py:95-110 (make_markov_state: v_eff 512, cycles of ~16,
     shared blocks, margin 30; full width, 16 of its 32 layers: a depth
     cut for the time limit) through
     quantize_model(W8A8), on phase 9's two pools with spec_k 4, n-grams of
     3 and spec windows of 8 rounds. Phase 9's script shape with prompts
     that walk the planted chain (192 requests, 16-256 prompt tokens,
     budgets 16-128, 8 sampled, 4 with a stop set). On each pool, the
     wrappers' counts set to 0 first: on the int8 pool warmup (the
     kernels, JAX's admission buckets eagerly, the four window graphs;
     the bf16 pool captures its graphs in its first windows), then the
     script through plain windows, spec windows, step_serve (on the int8
     pool: on this traffic it never leaves spec mode) and async windows
     (on the int8 pool only, a cut for the time limit), each printed
     with tok/s, ms per call (median, p90), drafted, accepted, the
     acceptance rate and the gain (tokens emitted per verify
     row); a full-pool verify against T=1 steps (verify_vs_steps); then a
     full pool's spec window and plain window profiled (device ms per
     verify round and per step, split by kernel; the kernels the card ran,
     asserted: kernel 3 spec_k x layers times a verify round on the int8
     pool) and one eager verify's launches (kernel 3 spec_k x layers,
     asserted).
     Asserted: no graph captured after the int8 pool's warmup; drafted >
     0; every request
     ends at its budget or its stop token; the greedy tokens of the spec,
     serve and async runs equal the plain run's up to each request's first
     near-tie (a chosen logprob below log 1/2); a snapshot of an 8-slot
     int8 spec pool serving 16 requests, after 2 step_serve calls with
     requests still queued, restored into a new engine, continues
     bit-equal to the uninterrupted run (sampled rows included);
     generate_speculative on a 64-token chain prompt equals greedy
     generate up to its first near-tie (forwards per token printed).
It prints each phase's host seconds as it ends. It then prints the
kernels line (one entry per ported TPU kernel, and one
per mode a later slice added to a path: the GEMMs' gelu_new epilogue,
flash decode's softcap and both attentions' ALiBi, kernels 3 and 8 at
phase 9's pools, kernels 1, 2 and 3 at phase 11's verify, and QUIK's
zero-point modes of kernels 2 and A; launches
summed over phases 5-11) and, last, the device line. Details go to
OUT_DIR/chip_smoke.json. Without a CUDA card, or without the package beside
it, the script exits non-zero and prints no result.
"""
import functools
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, tensor-core ops/s (f32:
# the CUDA cores)
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "bf16": 989e12, "f32": 67e12}
BF16_ULP = 2.0 ** -7
# flash decode against its plain version: two bf16 ulps of the output, plus
# this much for the few probabilities whose int8 (bf16) rounding an exp()
# ulp flips; on an H100 the kernel phase's cases come to 4.0e-3 (6e-5) beyond
# two ulps. A kernel that skips the probability quantization misses by
# more than 1.5x the int8 limit (tests/test_torch_flash_decode.py).
FLASH_ATOL = {"int8": 8e-3, "bf16": 5e-4}
OUT_DIR = "chiprun_out"


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def bound_ms(nbytes, ops):
    """(least time in ms, what bounds it) for moving `nbytes` and doing
    `ops`, a list of (count, peak key)."""
    t_bytes = nbytes / PEAK["bytes"]
    t_ops = sum(n / PEAK[kind] for n, kind in ops)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _device_us(prof):
    """Total duration of the work that ran on the card (kernels, copies,
    memsets) in the block of a kernels.card_trace window, in
    microseconds (kernels.block_events: without the spin kernels and a
    primer's work)."""
    from mixq_tpu_torch.kernels import block_events

    return sum(e.self_device_time_total for e in block_events(prof))


def device_ms(fn, iters, warmup=2):
    """Mean device time of one call: the durations of everything `iters`
    calls ran on the card (CUPTI, through torch.profiler), over `iters`.
    The host's gaps between kernels are left out, so a small kernel
    launched from Python is timed, not its launch."""
    from mixq_tpu_torch.kernels import card_trace

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # a profiler window now and then comes back with no device events at
    # all (seen once on the H100, in a library call); a window that sees
    # none three times fails
    for _ in range(3):
        with card_trace() as prof:
            for _ in range(iters):
                fn()
        us = _device_us(prof)
        if us > 0:
            return us / iters / 1e3
    raise SmokeError("the profiler saw no device time")


def rotating(fns):
    """A callable that calls the next of `fns` each time (distinct weight
    copies, so a timed GEMM finds its weight cold in the 50 MB L2, as the
    decode step does)."""
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1
    return call


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# the rows of phase 9's largest admission prefill: k_pad = 16 prompts of
# one 256-token bucket (CB_PREFILL_CHUNK), which phase 3 holds kernels 1 and
# 2 at and phase 9 asserts no admission passes
CB_PREFILL_M = 16 * 256
# Kernel 1's phase-3 rows, (M, H, a_bits): the decode step's M=64 at
# Llama-2-7B's and Gemma-2-9B's widths, A8 (W8A8 paths, o/down) and A4
# (q/k/v, up/gate of W4A4); generate's M=8; a prefill of 8 x 64 at M=512;
# phase 9's largest admission prefill
KERNEL1_ROWS = [(64, 4096, 8), (64, 4096, 4), (64, 3584, 8), (64, 3584, 4),
                (8, 4096, 8), (8, 4096, 4), (8, 3584, 8), (8, 3584, 4),
                (512, 4096, 8), (CB_PREFILL_M, 4096, 8)]
KERNEL1_TOL = ("y within 1 bf16 ulp, q_x within 1 LSB, x_scale rtol 1e-5 of "
               "the plain version (plus the relative distance of the row's "
               "inlier absmax of y, where that lands an ulp apart); q_x, "
               "x_scale, x_out bit-equal to the plain quantizer and gather "
               "fed the kernel's own y")


def trivial_launch_ms(dev):
    """The floor no launch can beat: a one-element zero_() on the card,
    timed as the kernels are."""
    z = torch.zeros(1, device=dev)
    return device_ms(z.zero_, 200)


def kernel1_inputs(dev, gen, M, H, a_bits, Bo=128):
    """Kernel 1's arguments at M rows of H channels with Bo outlier
    channels, A8 or A4, drawn from `gen`."""
    from mixq_tpu_torch.ops import quant as Q

    x = (torch.randn(M, H, generator=gen, device=dev) * 3).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
    oset = Q.outlier_set_from_indices(
        torch.randperm(H, generator=gen, device=dev)[:Bo], H, Bo, device=dev)
    return (x, gamma, oset.k_mask, 1e-5, a_bits, oset.ind, oset.mask)


def kernel1_close(got, ref, a_bits, k_mask):
    """Kernel 1's outputs `got` against its plain version's `ref` (on one
    device) under KERNEL1_TOL's limits: (ok, max |dy|, q_x's largest LSB
    distance, x_scale's largest relative distance). A row's x_scale is its
    absmax over the inlier channels of y: where that y lands an ulp apart
    (the norm's f32 sum in another order), x_scale may differ by as much
    as the two absmaxes do."""
    (y, q, s, xo), (yp, qp, sp, xop) = got, ref
    dy = (y.float() - yp.float()).abs()
    dq = (q.int() - qp.int()).abs().max().item()
    rel = (s - sp).abs() / sp

    def absmax(t):
        return (t.float() * k_mask.float()).abs().amax(-1, keepdim=True)

    a, ap = absmax(y), absmax(yp)
    ds_ok = bool((rel <= 1e-5 + (a - ap).abs() / ap).all())
    dxo = (xo.float() - xop.float()).abs()
    ok = (bool((dy <= BF16_ULP * yp.float().abs()).all()) and dq <= 1
          and ds_ok and q.abs().max().item() <= 2 ** (a_bits - 1) - 1
          and bool((dxo <= BF16_ULP * xop.float().abs()).all()))
    return ok, dy.max().item(), dq, rel.max().item()


def kernel1_held(got, args, what):
    """Holds kernel 1's outputs to KERNEL1_TOL on the card and on a CPU copy
    of its inputs: within the plain version's limits, and q_x, x_scale and
    x_out bit-equal to the plain quantizer and gather fed the kernel's own
    y. Returns the card's (max |dy|, q_x's LSB distance)."""
    from mixq_tpu_torch.kernels import rmsnorm_quant as RQ

    a_bits = args[4]
    cpu = tuple(t.cpu() if torch.is_tensor(t) else t for t in args)
    found = {}
    for where, a in (("card", args), ("CPU", cpu)):
        mine = tuple(t.to(a[0].device) for t in got)
        ok, dy, dq, ds = kernel1_close(mine, RQ.rmsnorm_quant_plain(*a),
                                      a_bits, a[2])
        check(ok, f"{what} disagrees with the plain version on the {where}: "
                  f"dy {dy} dq {dq} ds {ds}")
        own = RQ.quantize_normed(mine[0], a[2], a_bits, a[5], a[6])
        check(all(torch.equal(m, o) for m, o in zip(mine[1:], own)),
              f"{what}: q_x, x_scale or x_out is not the plain quantizer's "
              f"on the kernel's own y on the {where}")
        found[where] = (dy, dq)
    return found["card"]


def rmsnorm_row(dev, gen, M, H, a_bits, floor_ms, Bo=128):
    """Kernel 1 at M rows of H channels with Bo outlier channels, A8 or A4:
    held to KERNEL1_TOL (kernel1_held), then timed beside its bound, its
    plain version and `floor_ms`; each instantiation that takes the shape
    is held the same way, then timed."""
    from mixq_tpu_torch.kernels import rmsnorm_quant as RQ

    args = kernel1_inputs(dev, gen, M, H, a_bits, Bo)
    what = f"rmsnorm_quant M={M} H={H} A{a_bits}"
    got = RQ.fused_rmsnorm_quant(*args)
    torch.cuda.synchronize()
    dy, dq = kernel1_held(got, args, what)
    nbytes = (M * H * 2 + 2 * H * 4 + Bo * 8 + M * H * 3 + M * 4
              + M * Bo * 2)
    b, by = bound_ms(nbytes, [(8 * M * H, "f32")])
    row = dict(
        mode=f"A{a_bits}", work=f"M={M} H={H}, {Bo} outlier channels, "
                                f"A{a_bits}",
        tolerance=KERNEL1_TOL, max_abs_err=dy, q_lsb_err=dq,
        exact_from_own_y=True,
        ms=device_ms(lambda: RQ.fused_rmsnorm_quant(*args), 200),
        plain_ms=device_ms(lambda: RQ.rmsnorm_quant_plain(*args), 10),
        bound_ms=b, bound_by=by, library_ms=None, trivial_launch_ms=floor_ms,
        plan=RQ.plan_rmsnorm(H), ms_by_plan={})
    for plan in RQ.INSTANTIATIONS:
        if plan[1] and not row["plan"][1]:
            continue                      # the register kernel refuses H
        forced = RQ._rmsnorm(*args, plan=plan)
        torch.cuda.synchronize()
        kernel1_held(forced, args, f"{what} plan {plan}")
        row["ms_by_plan"][str(plan)] = device_ms(
            lambda: RQ._rmsnorm(*args, plan=plan), 200)
    key = (M, H, a_bits)
    if key in PREV_KERNEL1_MS:
        row.update(previous_ms=PREV_KERNEL1_MS[key], previous_from="64bb7fb")
    return row


def kernel_rmsnorm(dev, gen, rows):
    """KERNEL1_ROWS, beside the trivial-launch floor: the M=64 rows draw
    from the phase's generator (in the order the earlier phase 3 drew, so
    the later phases keep their inputs), the others from their own."""
    floor = trivial_launch_ms(dev)
    own = torch.Generator(device=dev).manual_seed(12)
    out_rows = [rmsnorm_row(dev, gen if M == 64 else own, M, H, a, floor)
                for M, H, a in KERNEL1_ROWS]
    rows["rmsnorm_quant"] = out_rows
    return out_rows[0]


# the linears of one Llama-2-7B block at decode: (name, K, N, fuse)
BLOCK = [("q", 4096, 4096, "none"), ("k", 4096, 4096, "none"),
         ("v", 4096, 4096, "none"), ("o", 4096, 4096, "none"),
         ("up", 4096, 11008, "none"), ("gate", 4096, 11008, "silu"),
         ("down", 11008, 4096, "none")]
W4_SLOTS = ("q", "k", "v", "up", "gate")        # W4A4 under the policy
GEMM_TOL = "1 bf16 ulp + 1e-4 max|y|"
INT_MM = ("torch._int_mm over a column-major copy of the int8 weight (the "
          "kernels read the row-major [K, N] weight; product only)")
# f32 operations of an epilogue per output (a transcendental counted as one)
EPILOGUE_OPS = {"none": 0, "silu": 5, "gelu": 4, "gelu_new": 9}
GELUS = ("gelu", "gelu_new")


def lib_epilogue(fuse):
    """What the library call adds to the product: F.gelu for a GELU row
    (the `library_ms` of a gelu epilogue is the product and F.gelu), and
    nothing for the other rows (the product only)."""
    import torch.nn.functional as F

    if fuse in GELUS:
        approximate = "tanh" if fuse == "gelu_new" else "none"
        return lambda y: F.gelu(y.float(), approximate=approximate)
    return lambda y: y


def lib_label(base, fuse):
    if fuse not in GELUS:
        return base
    return (base.replace("(product only)", "")
            + f"then F.gelu(approximate="
              f"{'tanh' if fuse == 'gelu_new' else 'none'})")


def copies_of(w, nbytes):
    """`w` and clones of it (strides kept) totalling >= 100 MB, so a timed
    GEMM that rotates over them finds its weight cold in the 50 MB L2, as
    the decode step does."""
    n = max(2, -(-100_000_000 // nbytes))
    return [w] + [w.clone() for _ in range(n - 1)]


def timed_gemm(kern, plain, lib, w, lib_w, wbytes, bound, **row):
    """Device ms of the kernel and the library call, each over rotated
    copies of its weight, and of the plain version, into one result row."""
    copies, lib_copies = copies_of(w, wbytes), copies_of(lib_w, wbytes)
    b, by = bound
    row.update(ms=device_ms(rotating([lambda c=c: kern(c) for c in copies]),
                            40),
               plain_ms=device_ms(plain, 5),
               library_ms=device_ms(rotating([lambda c=c: lib(c)
                                              for c in lib_copies]), 40),
               bound_ms=b, bound_by=by)
    return row


def block_row(kern, plain, lib, bounds, **row):
    """Device ms of a block's GEMMs run back to back on distinct weights, as
    the decode step runs them: the kernel, its plain version and the
    library call (None: no library row); the bound is the sum of
    theirs."""
    row.update(ms=device_ms(kern, 20), plain_ms=device_ms(plain, 3),
               library_ms=None if lib is None else device_ms(lib, 20),
               bound_ms=sum(b for b, _ in bounds),
               bound_by=("bytes" if all(by == "bytes" for _, by in bounds)
                         else "operations"))
    return row


def check_gemm(got, ref, what):
    err = (got.float() - ref.float()).abs()
    tol = BF16_ULP * ref.float().abs() + 1e-4 * ref.float().abs().max()
    check(bool((err <= tol).all()) and bool(torch.isfinite(got).all()),
          f"{what} disagrees: {err.max().item()}")
    return err.max().item()


def gemm_inputs(dev, gen, M, K, N, Bo, G=1, w4=False):
    """Operands of the int8-activation GEMM: A8/W8 (the W8A8 linears and
    o/down), or as q/k/v/up/gate of W4A4 give them (w4): A4 activations and
    packed int4 weights; [G, N] scales when G > 1. Also the library's
    operand: the int8 weight values, column-major (cuBLASLt)."""
    from mixq_tpu_torch.ops import quant as Q

    qa, (lo, hi) = (7 if w4 else 127), ((-8, 8) if w4 else (-127, 128))
    q_x = torch.randint(-qa, qa + 1, (M, K), generator=gen, device=dev,
                        dtype=torch.int8)
    q_w = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                        dtype=torch.int8)
    xs = torch.rand(M, 1, generator=gen, device=dev) * 1e-3 + 1e-4
    ws = torch.rand(*((G, N) if G > 1 else (N,)), generator=gen,
                    device=dev) * 1e-3 + 1e-4
    xo = torch.randn(M, Bo, generator=gen, device=dev).to(torch.bfloat16)
    wo = (torch.randn(Bo, N, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    w = Q.pack_int4(q_w) if w4 else q_w
    return (q_x, w, xs, ws, xo, wo), q_w.t().contiguous().t()


def gemm_bound(M, K, N, Bo, G=1, w4=False, fuse="none"):
    nbytes = (M * K + K * N // (2 if w4 else 1) + M * 4 + G * N * 4
              + M * Bo * 2 + Bo * N * 2 + M * N * 2)
    return bound_ms(nbytes, [(2 * M * N * K, "int8"), (2 * M * N * Bo,
                                                       "bf16"),
                             (EPILOGUE_OPS[fuse] * M * N, "f32")])


def gemm_cases(dev, gen, M, Bo, cases):
    """Kernels 2 and A, one (K, N, fuse, w4, G) shape at a time: checked
    against the plain version, then timed over rotated weight copies.
    Returns the rows and each case's error."""
    from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain

    out_rows, errs = [], []
    for K, N, fuse, w4, G in cases:
        ins, lib_w = gemm_inputs(dev, gen, M, K, N, Bo, G, w4)
        got = mix_gemm(*ins, fuse=fuse)
        torch.cuda.synchronize()
        mode = ("W4" if w4 else "W8A8") + (f" grouped G={G}" if G > 1 else "")
        err = check_gemm(got, mix_gemm_plain(*ins, fuse=fuse),
                         f"mix_gemm {mode} {K}x{N} {fuse}")
        errs.append(err)
        q_x, _, xs, ws, xo, wo = ins
        epi = lib_epilogue(fuse)
        out_rows.append(timed_gemm(
            lambda w: mix_gemm(q_x, w, xs, ws, xo, wo, fuse=fuse),
            lambda: mix_gemm_plain(*ins, fuse=fuse),
            lambda w: epi(torch._int_mm(q_x, w)), ins[1], lib_w,
            K * N // (2 if w4 else 1), gemm_bound(M, K, N, Bo, G, w4, fuse),
            work=f"{mode} M={M} K={K} N={N} fuse={fuse} B={Bo}", mode=mode,
            tolerance=GEMM_TOL, max_abs_err=err,
            library=lib_label(INT_MM, fuse), plan=mix_plan(M, K, N, w4, G),
            **previous(M, K, N, fuse, w4, G)))
        del ins, lib_w
    return out_rows, errs


def block_linears(names, w4, G_of, w8_names=()):
    """(name, K, N, fuse, w4, G) of the named linears of a Llama-2-7B block
    in one weight mode, and of `w8_names` in W8 with the same scales."""
    return [(n, K, N, f, w4 and n not in w8_names, G_of(K))
            for n, K, N, f in BLOCK if n in names]


def gemm_block(dev, gen, M, Bo, linears, **row):
    """The int8-activation GEMM (kernels 2 and A) over the linears (name,
    K, N, fuse, w4, G) of one block, as the decode step runs them (distinct
    weights, back to back)."""
    from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain

    seq = [gemm_inputs(dev, gen, M, K, N, Bo, G, w4) + (fuse,)
           for _, K, N, fuse, w4, G in linears]
    bounds = [gemm_bound(M, K, N, Bo, G, w4)
              for _, K, N, _, w4, G in linears]
    return block_row(
        lambda: [mix_gemm(*s[0], fuse=s[2]) for s in seq],
        lambda: [mix_gemm_plain(*s[0], fuse=s[2]) for s in seq],
        lambda: [torch._int_mm(s[0][0], s[1]) for s in seq], bounds,
        tolerance=GEMM_TOL, library=INT_MM, **row)


def kernel_mix_gemm(dev, gen, rows):
    """Kernel 2, W8A8: each distinct shape of a block alone, then the block
    of seven linears (~200 MB of weights), each with its split-K plan; then
    (own generator: the later phases keep their inputs) a prefill-shaped
    gate (M=512), the check that three plans give the same bits, and each
    distinct linear shape of the block at phase 9's largest admission
    prefill (M=CB_PREFILL_M)."""
    M, Bo = 64, 128
    out_rows, errs = gemm_cases(dev, gen, M, Bo, [
        (K, N, f, False, 1) for K, N, f in
        sorted({(K, N, f) for _, K, N, f in BLOCK})])
    linears = block_linears([n for n, *_ in BLOCK], False, lambda K: 1)
    blk = gemm_block(
        dev, gen, M, Bo, linears, mode="W8A8", max_abs_err=max(errs),
        work=f"the 7 linears of one Llama-2-7B block at M={M}, {Bo} "
             "outlier channels each (q,k,v,o 4096x4096; up, gate+SiLU "
             "4096x11008; down 11008x4096)",
        plan=block_plans(M, linears), **previous("block"))
    own = torch.Generator(device=dev).manual_seed(7)
    prefill, _ = gemm_cases(dev, own, 512, Bo, [(4096, 11008, "silu", False,
                                                  1)])
    blk["bit_equal_plans"] = plans_bit_equal(dev, own)
    admit, _ = gemm_cases(dev, torch.Generator(device=dev).manual_seed(8),
                          CB_PREFILL_M, Bo, [
                              (K, N, f, False, 1) for K, N, f in
                              sorted({(K, N, f) for _, K, N, f in BLOCK})])
    rows["mix_gemm"] = out_rows + [blk] + prefill + admit
    return blk


def plans_bit_equal(dev, gen):
    """The per-channel modes' split partials are int32 and add exactly, and
    the outlier term runs the same MMAs at any split: the plan's S, S = 1
    and S = 2 give the same bits, in kernel 2 (down 11008x4096) and in
    kernel A's W4 (q 4096x4096, A4 activations), at M=64 with 128 outlier
    channels and SiLU."""
    from mixq_tpu_torch.kernels.mix_gemm import _mix_gemm

    M, out = 64, []
    for K, N, w4 in ((11008, 4096, False), (4096, 4096, True)):
        ins, _ = gemm_inputs(dev, gen, M, K, N, 128, w4=w4)
        plan = mix_plan(M, K, N, w4)
        splits = sorted({1, 2, plan["splits"]})
        runs = [_mix_gemm(*ins, "silu", torch.bfloat16, splits=S)
                for S in splits]
        torch.cuda.synchronize()
        for S, r in zip(splits[1:], runs[1:]):
            check(torch.equal(runs[0].view(torch.uint8), r.view(torch.uint8)),
                  f"mix_gemm {'W4' if w4 else 'W8A8'} {K}x{N}: S = {S} "
                  "differs from S = 1")
        out.append(dict(K=K, N=N, M=M, w4=w4, splits=splits, plan=plan))
    return out


def kernel_a_blocks(gs=128):
    """Kernel A's blocks at decode, as the W4A4 paths run them: (key, mode,
    linears, what) for the five W4 linears of a block, per-channel and with
    gs-row scale groups, and the seven of the grouped path's block (the W4
    five and its W8A8 o/down, all grouped)."""
    def g(K):
        return K // gs

    five = ("(q,k,v 4096x4096; up, gate+SiLU 4096x11008)")
    return [
        ("block W4", "W4", block_linears(W4_SLOTS, True, lambda K: 1),
         f"the five W4 linears of one Llama-2-7B W4A4 block {five}"),
        ("block W4 g128", f"W4 grouped group_size={gs}",
         block_linears(W4_SLOTS, True, g),
         f"the five W4 grouped linears of one Llama-2-7B W4A4 block {five}"),
        ("block g128 path", f"W4 and W8A8 grouped group_size={gs}",
         block_linears([n for n, *_ in BLOCK], True, g, ("o", "down")),
         "the seven linears of one Llama-2-7B W4A4 group_size=128 block as "
         "its path runs them (q,k,v 4096x4096, up, gate+SiLU 4096x11008 W4 "
         "grouped; o 4096x4096, down 11008x4096 W8A8 grouped)")]


def block_plans(M, linears):
    return {n: mix_plan(M, K, N, w4, G) for n, K, N, _, w4, G in linears}


def kernel_w4_gemm(dev, gen, rows):
    """Kernel A: the packed-W4 linears of a W4A4 block (q, k, v, up, gate+
    SiLU), per-channel and with 128-row scale groups, and the grouped W8A8
    o/down of the grouped W4A4 path; each shape alone over rotated weight
    copies, then each block as the decode step runs it (kernel_a_blocks)."""
    M, Bo, gs = 64, 128, 128
    w4_shapes = sorted({(K, N, f) for n, K, N, f in BLOCK if n in W4_SLOTS})
    out_rows, errs = gemm_cases(dev, gen, M, Bo, (
        [(K, N, f, True, 1) for K, N, f in w4_shapes]
        + [(K, N, f, True, K // gs) for K, N, f in w4_shapes]
        + [(K, N, f, False, K // gs) for n, K, N, f in BLOCK
           if n in ("o", "down")]))
    n = len(w4_shapes)
    # the g128 path's block on its own generator: the later phases keep
    # their inputs
    own = torch.Generator(device=dev).manual_seed(8)
    blocks = [gemm_block(
        dev, gen if i < 2 else own, M, Bo, linears, mode=mode,
        max_abs_err=max(errs[:n] if i == 0 else errs[n:2 * n] if i == 1
                        else errs[n:]),
        work=f"{what} at M={M}, {Bo} outlier channels each",
        plan=block_plans(M, linears), **previous(key))
        for i, (key, mode, linears, what) in enumerate(kernel_a_blocks(gs))]
    rows["mix_gemm_w4_grouped"] = out_rows + blocks
    return blocks[0]


# QUIK (ROADMAP Queue A item 4): the zero-point modes of kernels 2 and A.
# Its Llama-2-7B block: q/k/v/up/gate W4 (A4 asymmetric), o/down W8 (A8
# asymmetric), 256 fp outlier channels on every linear input
# (QuantConfig.quik_w4a4). M=64 is the decode step's batch, M=8 generate's,
# M=2,048 phase 10's window batch (8 x 256).
QUIK_BO = 256
QUIK_W8 = ("o", "down")
QUIK_LIB = ("torch._int_mm over an unpacked column-major copy of the int "
            "weight, then the zero-point epilogue, the bf16 outlier matmul "
            "and the activation in torch ops (a yardstick: the port never "
            "calls it)")
# f32 operations of the zero-point dequant per output: x_scale * w_scale,
# x_zero * reduced_w, the add and the multiply
ZP_OPS = 4


def quik_inputs(dev, gen, M, K, N, w4, Bo=QUIK_BO):
    """QUIK operands: bf16 activations through the asymmetric quantizer
    (A4 for packed W4, A8 for W8), row 0 all zeros (every channel an
    outlier) and row 1 with one large negative channel (q at -8 / -128);
    random int weights and their reduced_w; Bo outlier channels. Returns
    (mix_gemm's positional operands, its zero-point keywords, the library's
    int8 weight, column-major)."""
    from mixq_tpu_torch.ops import quant as Q

    x = torch.randn(M, K, generator=gen, device=dev) * 0.5
    x[0] = 0.0
    if M > 1:
        x[1, 3] = -40.0
    q_x, xs, xz = Q.quantize_act_asymmetric(x.to(torch.bfloat16),
                                            bits=4 if w4 else 8)
    lo, hi = (-8, 8) if w4 else (-127, 128)
    q_w = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                        dtype=torch.int8)
    ws = torch.rand(N, generator=gen, device=dev) * 1e-2 + 1e-3
    xo = torch.randn(M, Bo, generator=gen, device=dev).to(torch.bfloat16)
    wo = (torch.randn(Bo, N, generator=gen, device=dev) * 0.05).to(
        torch.bfloat16)
    w = Q.pack_int4(q_w) if w4 else q_w
    zp = dict(x_zero=xz, reduced_w=Q.reduced_weight_rowsum(q_w))
    return (q_x, w, xs, ws, xo, wo), zp, q_w.t().contiguous().t()


def quik_bound(M, K, N, w4, fuse="none", Bo=QUIK_BO):
    nbytes = (M * K + K * N // (2 if w4 else 1) + M * 8 + N * 8
              + M * Bo * 2 + Bo * N * 2 + M * N * 2)
    return bound_ms(nbytes, [(2 * M * N * K, "int8"),
                             (2 * M * N * Bo, "bf16"),
                             ((EPILOGUE_OPS[fuse] + ZP_OPS) * M * N, "f32")])


def quik_lib(ins, zp, fuse):
    """The library yardstick of one zero-point call on the int8 weight
    `lib_w` (QUIK_LIB)."""
    import torch.nn.functional as F

    q_x, _, xs, ws, xo, wo = ins
    scale = xs * ws[None, :]
    corr = zp["x_zero"] * zp["reduced_w"][None, :]

    def call(lib_w):
        y = scale * (torch._int_mm(q_x, lib_w).float() + corr)
        y = y + torch.matmul(xo, wo).float()
        return (F.silu(y) if fuse == "silu" else y).to(torch.bfloat16)
    return call


def quik_linears():
    """(name, K, N, fuse, w4) of the Llama-2-7B QUIK block's linears."""
    return [(n, K, N, f, n not in QUIK_W8) for n, K, N, f in BLOCK]


def quik_block(dev, gen, M, linears, **row):
    """Kernels 2 and A in their zero-point modes over `linears` of one
    block, as the decode step runs them (distinct weights, back to back):
    each linear held to its plain version first."""
    from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain

    seq = [quik_inputs(dev, gen, M, K, N, w4) + (fuse,)
           for _, K, N, fuse, w4 in linears]
    errs = []
    for (name, K, N, fuse, w4), (ins, zp, _, _) in zip(linears, seq):
        got = mix_gemm(*ins, fuse=fuse, **zp)
        torch.cuda.synchronize()
        errs.append(check_gemm(got, mix_gemm_plain(*ins, fuse=fuse, **zp),
                               f"QUIK {name} {K}x{N} M={M}"))
    libs = [(quik_lib(ins, zp, fuse), lw) for ins, zp, lw, fuse in seq]
    # torch._int_mm takes more than 16 rows: no library row at M=8
    return block_row(
        lambda: [mix_gemm(*s[0], fuse=s[3], **s[1]) for s in seq],
        lambda: [mix_gemm_plain(*s[0], fuse=s[3], **s[1]) for s in seq],
        (lambda: [f(lw) for f, lw in libs]) if M > 16 else None,
        [quik_bound(M, K, N, w4, fuse) for _, K, N, fuse, w4 in linears],
        tolerance=GEMM_TOL, library=QUIK_LIB, max_abs_err=max(errs),
        plan={n: mix_plan(M, K, N, w4, zp=True)
              for n, K, N, _, w4 in linears}, **row)


def quik_plans_bit_equal(dev, gen):
    """The zero-point term is added once, to the sum of the splits' int32
    partials: S = 1..8 give the same bits, in both modes (q 4096x4096 W4
    A4, down 11008x4096 W8 A8), at M=64 with 256 outlier channels (two
    chunks of 128) and SiLU."""
    from mixq_tpu_torch.kernels.mix_gemm import _mix_gemm

    M, out = 64, []
    for K, N, w4 in ((4096, 4096, True), (11008, 4096, False)):
        ins, zp, _ = quik_inputs(dev, gen, M, K, N, w4)
        splits = list(range(1, 9))
        runs = [_mix_gemm(*ins, "silu", torch.bfloat16, splits=S, **zp)
                for S in splits]
        torch.cuda.synchronize()
        for S, r in zip(splits[1:], runs[1:]):
            check(torch.equal(runs[0].view(torch.uint8), r.view(torch.uint8)),
                  f"QUIK {'W4' if w4 else 'W8'} {K}x{N}: S = {S} differs "
                  "from S = 1")
        out.append(dict(K=K, N=N, M=M, w4=w4, splits=splits,
                        plan=mix_plan(M, K, N, w4, zp=True)))
    return out


def kernel_quik(dev, rows):
    """Kernels 2 and A in QUIK's zero-point modes (on a generator of their
    own, so the other phases' inputs stay as they were): each distinct
    linear shape of the QUIK block at M=64 alone, over rotated weight
    copies; the five W4 linears, the two W8 ones and the block of seven
    at M=64, the seven at M=8 and at M=2,048; the bits across forced
    split plans. Returns (the W8 rows' block, the W4 rows' block)."""
    from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain

    gen = torch.Generator(device=dev).manual_seed(19)
    M = 64
    out_rows = []
    for K, N, fuse, w4 in sorted({(K, N, f, w4)
                                  for _, K, N, f, w4 in quik_linears()}):
        ins, zp, lib_w = quik_inputs(dev, gen, M, K, N, w4)
        got = mix_gemm(*ins, fuse=fuse, **zp)
        torch.cuda.synchronize()
        mode = "W4 zero point" if w4 else "W8A8 zero point"
        err = check_gemm(got, mix_gemm_plain(*ins, fuse=fuse, **zp),
                         f"mix_gemm {mode} {K}x{N} {fuse}")
        q_x, _, xs, ws, xo, wo = ins
        out_rows.append(timed_gemm(
            lambda w: mix_gemm(q_x, w, xs, ws, xo, wo, fuse=fuse, **zp),
            lambda: mix_gemm_plain(*ins, fuse=fuse, **zp),
            quik_lib(ins, zp, fuse), ins[1], lib_w,
            K * N // (2 if w4 else 1), quik_bound(M, K, N, w4, fuse),
            work=f"{mode} M={M} K={K} N={N} fuse={fuse} B={QUIK_BO}",
            mode=mode, tolerance=GEMM_TOL, max_abs_err=err,
            library=QUIK_LIB, plan=mix_plan(M, K, N, w4, zp=True)))
        del ins, zp, lib_w
    five = "(q,k,v 4096x4096; up, gate+SiLU 4096x11008)"
    lin = quik_linears()
    w4_blk = quik_block(
        dev, gen, M, [x for x in lin if x[4]], mode="W4 zero point",
        work=f"the five W4 linears of one Llama-2-7B QUIK block {five} at "
             f"M={M}, A4 asymmetric, {QUIK_BO} outlier channels each")
    w8_blk = quik_block(
        dev, gen, M, [x for x in lin if not x[4]], mode="W8A8 zero point",
        work=f"the two W8 linears of one Llama-2-7B QUIK block (o "
             f"4096x4096, down 11008x4096) at M={M}, A8 asymmetric, "
             f"{QUIK_BO} outlier channels each")
    blocks = [quik_block(
        dev, gen, m, lin, mode="W4 and W8A8 zero point",
        work=f"the seven linears of one Llama-2-7B QUIK block at M={m} "
             f"(q,k,v, up, gate+SiLU W4 A4; o, down W8 A8; {QUIK_BO} "
             "outlier channels each)") for m in (M, 8, 2048)]
    blocks[0]["bit_equal_plans"] = quik_plans_bit_equal(dev, gen)
    rows["mix_gemm_zero_point"] = out_rows + [w4_blk, w8_blk] + blocks
    return w8_blk, w4_blk


# Phase 10's prefill shapes (Bo = 128 outlier channels, as quantize_model
# gives every MIX linear). The tiny gate (H=256, I=704) prefills windows
# of 8 x 128 rows: kernel 1 at A8 (mix8) and A4 (the mix4 configs); W8A8
# on every linear of mix8 and on o/down of mix4; W4 on q/k/v/up/gate of
# mix4; W4 with 64-row groups on q/k/v/up/gate of mix4_g64 and on every
# linear of mix4_full_g64 (down: K=704 in 11 groups, one across the packed
# halves); W8A8 with 64-row groups on o/down of mix4_g64. The 7B gate
# prefills 8 x 256 rows (W8A8 on mix8 and on mix4's o/down, W4 on mix4's
# q/k/v/up/gate) and its timed 32-window batch 32 x 256 rows (mix8).
TINY_LINEARS = [(256, 256, "none"), (256, 704, "none"), (256, 704, "silu"),
                (704, 256, "none")]
EVAL_KERNEL1_ROWS = [(8 * 128, 256, 8), (8 * 128, 256, 4),
                     (8 * 256, 4096, 8), (8 * 256, 4096, 4),
                     (32 * 256, 4096, 8)]


def eval_gemm_cases():
    """{M: [(K, N, fuse, w4, G)]} of phase 10's int8-activation GEMMs."""
    tiny = ([(K, N, f, False, 1) for K, N, f in TINY_LINEARS]
            + [(K, N, f, True, 1) for K, N, f in TINY_LINEARS if K == 256]
            + [(K, N, f, True, K // 64) for K, N, f in TINY_LINEARS]
            + [(K, N, f, False, K // 64) for K, N, f in TINY_LINEARS
               if N == 256])
    shapes = sorted({(K, N, f) for _, K, N, f in BLOCK})
    w8 = [(K, N, f, False, 1) for K, N, f in shapes]
    w4 = [(K, N, f, True, 1) for K, N, f in
          sorted({(K, N, f) for n, K, N, f in BLOCK if n in W4_SLOTS})]
    return {8 * 128: tiny, 8 * 256: w8 + w4, 32 * 256: w8}


def kernel_eval_shapes(dev, rows):
    """Kernels 1, 2 and A at phase 10's prefill shapes, each held to its
    plain version on the same inputs (KERNEL1_TOL, GEMM_TOL) and timed as
    the other phase-3 rows, on a generator of its own."""
    own = torch.Generator(device=dev).manual_seed(10)
    floor = trivial_launch_ms(dev)
    rows["rmsnorm_quant_eval"] = [rmsnorm_row(dev, own, M, H, a, floor)
                                  for M, H, a in EVAL_KERNEL1_ROWS]
    rows["mix_gemm_eval"] = [
        r for M, cases in eval_gemm_cases().items()
        for r in gemm_cases(dev, own, M, 128, cases)[0]]


# phase 11's verify forward: spec_k = 4 tokens of each of 64 slots, rows
# through kernels 1 and 2 (spec windows, step_spec)
VERIFY_M = 64 * 4


def kernel_verify_shapes(dev, rows):
    """Kernels 1 and 2 at phase 11's verify rows (M = VERIFY_M, A8, at
    Llama-2-7B's block shapes) and kernel 3 at the verify's per-row lengths
    (phase 11's int8 pool: a row's last verify token at slot_lengths + 4,
    slot_lengths over [0, S - 4]), each held to its plain version on the
    same inputs and timed beside its bound, its plain version and, for the
    GEMMs, `_int_mm`, on a generator of its own. Returns the rows of the
    kernels line: kernel 1, kernel 2 on up (4096 x 11008), kernel 3."""
    own = torch.Generator(device=dev).manual_seed(17)
    floor = trivial_launch_ms(dev)
    rows["rmsnorm_quant_verify"] = [rmsnorm_row(dev, own, VERIFY_M, 4096, 8,
                                                floor)]
    shapes = sorted({(K, N, f) for _, K, N, f in BLOCK})
    rows["mix_gemm_verify"] = gemm_cases(
        dev, own, VERIFY_M, 128,
        [(K, N, f, False, 1) for K, N, f in shapes])[0]
    rows["flash_decode_verify"] = [flash_row(
        dev, own, CB_SLOTS, CB_SEQ, 32, 32, 128, True, pool=True,
        verify=SPEC_K)]
    up = next(r for r in rows["mix_gemm_verify"]
              if "K=4096 N=11008 fuse=none" in r["work"])
    return (rows["rmsnorm_quant_verify"][0], up,
            rows["flash_decode_verify"][0])


def a16_inputs(dev, gen, M, K, N, G, w4):
    from mixq_tpu_torch.kernels.w8a16 import dequant_weight
    from mixq_tpu_torch.ops import quant as Q

    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    lo, hi = (-8, 8) if w4 else (-127, 128)
    q_w = torch.randint(lo, hi, (K, N), generator=gen, device=dev,
                        dtype=torch.int8)
    ws = torch.rand(*((G, N) if G > 1 else (N,)), generator=gen,
                    device=dev) * 1e-3 + 1e-4
    w = Q.pack_int4(q_w) if w4 else q_w
    # the library's operand: the same bf16-rounded weight, dequantized ahead
    return (x, w, ws), dequant_weight(w, ws)


def a16_bound(M, K, N, G, w4, fuse="none"):
    nbytes = M * K * 2 + K * N // (2 if w4 else 1) + G * N * 4 + M * N * 2
    return bound_ms(nbytes, [(2 * M * N * K, "bf16"),
                             (EPILOGUE_OPS[fuse] * M * N, "f32")])


def check_a16(got, ref, x, wd, what):
    """1 bf16 ulp of |y| + 1e-5 * (|x| @ |wd|): the same bf16 operands and
    exact products on both sides, summed in another order."""
    S = x.float().abs() @ wd.float().abs()
    err = (got.float() - ref.float()).abs()
    check(bool((err <= BF16_ULP * ref.float().abs() + 1e-5 * S).all())
          and bool(torch.isfinite(got).all()),
          f"{what} disagrees: {err.max().item()}")
    return err.max().item()


A16_TOL = "1 bf16 ulp + 1e-5 (|x| @ |wd|)"
A16_LIB = ("torch.matmul of x with the pre-dequantized bf16 weight (product "
           "only)")


# ptxas reports by (w4, grouped) instantiation, filled by main(): kernel B's
# and the int8-activation GEMM's (kernels 2 and A); flash decode's by
# (g, int8, softcap)
A16_PTXAS = {}
MIX_PTXAS = {}
ZP_PTXAS = {}
RMS_PTXAS = {}
FLASH_PTXAS = {}
DECODE_PTXAS = {}


def ptxas_by_mode(log, kernel):
    """Registers and spills of each instantiation of `kernel` in a `ptxas
    -v` log, keyed by its template arguments (ints and bools, from the
    mangled name): (w4, grouped) for w8a16_kernel and mix_gemm_kernel,
    (g, int8, softcap) for flash_decode_kernel and
    decode_attention_kernel, (threads, chunks) for rmsnorm_quant_regs."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            key = None
            if f"{kernel}I" in ln:
                args = ln.split(f"{kernel}I", 1)[1].split("EE", 1)[0] + "E"
                key = tuple(int(v) if t == "i" else v == "1" for t, v in
                            re.findall(r"L([ib])(\d+)E", args))
        elif key is not None and "spill stores" in ln:
            out.setdefault(key, {})["spills"] = ln.strip()
        elif key is not None and "Used" in ln and "registers" in ln:
            out.setdefault(key, {})["registers"] = int(
                ln.split("Used", 1)[1].split()[0])
    return out


# The MIX instantiations' registers by (w4, grouped), as ptxas reported them
# before the zero-point mode was added (CUDA 12.8, sm_90a): the mode must
# leave them as they were.
MIX_REGISTERS = {(False, False): 128, (True, False): 161, (False, True): 224,
                 (True, True): 240}


# Kernel 3's times before its redesign (one block of 4 warps per (kv head,
# batch row) walking the whole row, commit 234e8be), by phase-3 row at B=64
# (model, n_q, n_kv, D, mode). Not measured in the run that prints them:
# the mean of two runs of this script on 234e8be's tree in one chip call
# (run F of PERF.md's findings on this redesign), in turns with the new one,
# on an NVIDIA H100 80GB HBM3 at 700.00 W.
PREV_KERNEL3_MS = {
    ("Llama-2-7B", 32, 32, 128, "int8 KV"): 0.0931,
    ("Llama-2-7B", 32, 32, 128, "bf16 KV"): 0.1302,
    ("Llama-2-7B", 32, 8, 128, "int8 KV"): 0.0810,
    ("Gemma-2-9B", 16, 8, 256, "int8 KV"): 0.1147,
    ("Gemma-2-9B", 16, 8, 256, "int8 KV, softcap 50, scale 0.0625"): 0.1239,
    ("Gemma-2-9B", 16, 8, 256, "bf16 KV, softcap 50, scale 0.0625"): 0.1959,
    ("Gemma-2-9B", 16, 8, 256,
     "int8 KV, softcap 50, scale 0.0625, peaked (q x 3)"): 0.1267,
    ("Gemma-2-9B", 16, 8, 256,
     "bf16 KV, softcap 50, scale 0.0625, peaked (q x 3)"): 0.1921,
    ("Gemma-2-27B", 32, 16, 128,
     "int8 KV, softcap 50, scale 0.0833333"): 0.0727,
}


# Kernel 1's times before its redesign (one block of 256 threads a row,
# three passes with 2-byte loads, commit 64bb7fb), by phase-3 row (M, H,
# a_bits). Not measured in the run that prints them: the means of two runs
# of time_prefill.py --kernel1 on 64bb7fb's package in one chip call, in
# turns with the redesigned kernel, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md's kernel-1 findings, run F).
PREV_KERNEL1_MS = {
    (64, 4096, 8): 0.00609,
    (64, 4096, 4): 0.00621,
    (64, 3584, 8): 0.00644,
    (64, 3584, 4): 0.00674,
    (8, 4096, 8): 0.00634,
    (8, 4096, 4): 0.00623,
    (8, 3584, 8): 0.00650,
    (8, 3584, 4): 0.00666,
    (512, 4096, 8): 0.00942,
}


# Kernel 8's times before its redesign (one block of 4 warps per (kv head,
# batch row) walking the whole row in f32, commit 171275c), by phase-3 row
# (model, n_q, n_kv, D, mode, B), and its device ms per decode step on the
# batch-major serve paths. Not measured in the run that prints them: the
# means of two runs of this script on 171275c's tree in one chip call, in
# turns with the redesigned kernel, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md's kernel-8 findings).
PREV_KERNEL8_MS = {
    ("Mistral-7B", 32, 8, 128, "int8 KV", 64): 0.1078,
    ("Llama-2-7B", 32, 32, 128, "bf16 KV", 64): 0.1413,
    ("Mistral-7B", 32, 8, 128, "int8 KV, ring past the wrap", 16): 0.4960,
    ("Gemma-2-9B", 16, 8, 256, "int8 KV, softcap 50, scale 0.0625", 64):
        0.1126,
    ("Mistral-7B", 32, 8, 128, "int8 KV, peaked (q x 3)", 64): 0.1072,
}
PREV_KERNEL8_STEP_MS = {"Mistral-7B W8A8O16": 4.837,
                        "Llama-2-7B W8A8O16 bf16 KV": 6.147}


# Kernel 2's times before its redesign (the 64 x 32-tile kernel that walked
# all of K in one block, commit fb5c82e), by (M, K, N, fuse), for the block
# of seven and for the int8_matmul_dequant row. Not measured in the run that
# prints them: the mean of two runs of this script on fb5c82e's tree, and
# for M=512 of two runs of time_prefill.py --package on it, in one chip
# call each beside the redesigned kernel, on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md's kernel-2 table).
PREV_KERNEL2_MS = {
    (64, 4096, 4096, "none"): 0.0546,
    (64, 4096, 11008, "none"): 0.1166,
    (64, 4096, 11008, "silu"): 0.1176,
    (64, 11008, 4096, "none"): 0.1350,
    "block": 0.5901,
    (64, 3584, 2048, "none"): 0.0479,
    (64, 3584, 4096, "none"): 0.0483,
    (64, 3584, 14336, "gelu_new"): 0.2068,
    (64, 3584, 14336, "none"): 0.2058,
    (64, 4096, 3584, "none"): 0.0543,
    (64, 14336, 3584, "none"): 0.1725,
    (64, 3584, 14336, "gelu"): 0.2065,
    "int8_matmul_dequant": 0.0520,
    (512, 4096, 11008, "silu"): 0.8008,
}


# Kernel A's times before its redesign (the 64 x 32-tile WMMA kernel that
# walked all of K in one block, commit 99187cf), by (M, K, N, fuse, w4, G)
# and by block (kernel_a_blocks). Not measured in the run that prints them:
# the means of two runs of this script on 99187cf's tree (the g128 path's
# block: of two runs of time_prefill.py --package on it), in one chip call
# beside the redesigned kernel, on an NVIDIA H100 80GB HBM3 at 700.00 W
# (PERF.md's kernel-A table).
PREV_KERNEL_A_MS = {
    (64, 4096, 4096, "none", True, 1): 0.0697,
    (64, 4096, 11008, "none", True, 1): 0.1057,
    (64, 4096, 11008, "silu", True, 1): 0.1064,
    (64, 4096, 4096, "none", True, 32): 0.0849,
    (64, 4096, 11008, "none", True, 32): 0.1245,
    (64, 4096, 11008, "silu", True, 32): 0.1246,
    (64, 4096, 4096, "none", False, 32): 0.1013,
    (64, 11008, 4096, "none", False, 86): 0.2757,
    "block W4": 0.4345,
    "block W4 g128": 0.5238,
    "block g128 path": 0.9040,
    (64, 3584, 2048, "none", True, 1): 0.0619,
    (64, 3584, 4096, "none", True, 1): 0.0611,
    (64, 3584, 14336, "gelu_new", True, 1): 0.1768,
    (64, 3584, 14336, "none", True, 1): 0.1742,
}


def previous(*key):
    """The earlier kernel's time for a row, by a gemm_cases key (M, K, N,
    fuse, w4, G) or a row's name, with the commit it ran on; nothing for
    a row without one."""
    if len(key) == 1:                     # a name
        key = key[0]
    if key in PREV_KERNEL_A_MS:
        return dict(previous_ms=PREV_KERNEL_A_MS[key],
                    previous_from="99187cf")
    k2 = key
    if len(key) == 6:
        k2 = None if key[4] or key[5] > 1 else key[:4]
    if k2 in PREV_KERNEL2_MS:
        return dict(previous_ms=PREV_KERNEL2_MS[k2], previous_from="fb5c82e")
    return {}


def mix_plan(M, K, N, w4=False, G=1, zp=False):
    """The int8-activation GEMM's plan for this call (BN, splits S,
    blocks), the clusters of S blocks the card holds at once, and the
    ptxas report of its instantiation (zp: the zero-point kernel's)."""
    from mixq_tpu_torch.kernels import _build
    from mixq_tpu_torch.kernels.mix_gemm import _clusters, plan_mix

    clusters = _clusters(0, w4, G > 1, zp)
    p = plan_mix(M, N, K, w4, G, _build.sm_count(0), clusters)
    return dict(bn=p.bn, splits=p.splits, blocks=p.blocks,
                max_active_clusters=clusters[p.splits - 1],
                **(ZP_PTXAS.get((w4,), {}) if zp
                   else MIX_PTXAS.get((w4, G > 1), {})))


def a16_plan(M, K, N, w4, G):
    """Kernel B's plan for this call (BN, splits S, blocks), the clusters
    of S blocks the card holds at once, and the ptxas report of its
    instantiation."""
    from mixq_tpu_torch.kernels import _build
    from mixq_tpu_torch.kernels.w8a16 import _clusters, plan_a16

    clusters = _clusters(0, w4, G > 1)
    p = plan_a16(M, N, K, w4, G, _build.sm_count(0), clusters)
    return dict(bn=p.bn, splits=p.splits, blocks=p.blocks,
                max_active_clusters=clusters[p.splits - 1],
                **A16_PTXAS.get((w4, G > 1), {}))


def a16_row(dev, gen, M, K, N, fuse, w4, G, gemm_rule=False):
    """Kernel B at one shape: checked against its plain version (under the
    a16 rule, or check_gemm's with `gemm_rule`), then timed over rotated
    weight copies."""
    from mixq_tpu_torch.kernels.w8a16 import mix_gemm_a16, w8a16_plain

    ins, wd = a16_inputs(dev, gen, M, K, N, G, w4)
    mode = ("W4A16" if w4 else "W8A16") + (f" grouped G={G}" if G > 1
                                            else "")
    got = mix_gemm_a16(*ins, fuse=fuse)
    torch.cuda.synchronize()
    ref = w8a16_plain(*ins, fuse=fuse)
    what = f"mix_gemm_a16 {mode} {K}x{N} {fuse}"
    err = (check_gemm(got, ref, what) if gemm_rule
           else check_a16(got, ref, ins[0], wd, what))
    x, _, ws = ins
    epi = lib_epilogue(fuse)
    return timed_gemm(
        lambda w: mix_gemm_a16(x, w, ws, fuse=fuse),
        lambda: w8a16_plain(*ins, fuse=fuse),
        lambda w: epi(torch.matmul(x, w)), ins[1], wd,
        K * N // (2 if w4 else 1), a16_bound(M, K, N, G, w4, fuse),
        work=f"{mode} M={M} K={K} N={N} fuse={fuse}", mode=mode,
        tolerance=GEMM_TOL if gemm_rule else A16_TOL, max_abs_err=err,
        library=lib_label(A16_LIB, fuse), plan=a16_plan(M, K, N, w4, G))


def kernel_a16(dev, gen, rows):
    """Kernel B: the seven W8A16 linears of a block, each shape alone over
    rotated weight copies and then the block as the decode step runs it;
    one packed-W4 (W4A16) and one grouped case at 4096x11008; row 5's
    w8a16_matmul entry at 4096x4096."""
    from mixq_tpu_torch.kernels.w8a16 import (mix_gemm_a16, w8a16_matmul,
                                              w8a16_plain)

    M = 64
    cases = ([(K, N, f, False, 1) for K, N, f in
              sorted({(K, N, f) for _, K, N, f in BLOCK})]
             + [(4096, 11008, "none", True, 1),
                (4096, 11008, "none", False, 32)])
    out_rows = [a16_row(dev, gen, M, K, N, fuse, w4, G)
                for K, N, fuse, w4, G in cases]
    errs = [r["max_abs_err"] for r, (_, _, _, w4, G) in zip(out_rows, cases)
            if not w4 and G == 1]
    seq = [a16_inputs(dev, gen, M, K, N, 1, False) + (fuse,)
           for _, K, N, fuse in BLOCK]
    block = block_row(
        lambda: [mix_gemm_a16(*s[0], fuse=s[2]) for s in seq],
        lambda: [w8a16_plain(*s[0], fuse=s[2]) for s in seq],
        lambda: [torch.matmul(s[0][0], s[1]) for s in seq],
        [a16_bound(M, K, N, 1, False) for _, K, N, _ in BLOCK],
        work=f"the seven W8A16 linears of one Llama-2-7B block at M={M} "
             "(q,k,v,o 4096x4096; up, gate+SiLU 4096x11008; down "
             "11008x4096)",
        mode="W8A16", tolerance=A16_TOL, max_abs_err=max(errs),
        library=A16_LIB,
        plan={n: a16_plan(M, K, N, False, 1) for n, K, N, _ in BLOCK})
    del seq
    # split K is summed in rank order inside the cluster: two launches on
    # the same inputs are bit-equal (down 11008x4096, S = 7, uneven splits,
    # 128 outlier channels, SiLU; and packed W4 with 128-row groups)
    # (own generator: the later phases keep their inputs)
    own = torch.Generator(device=dev).manual_seed(6)
    for K, N, w4, G in ((11008, 4096, False, 1), (4096, 11008, True, 32)):
        (x, w, ws), _ = a16_inputs(dev, own, M, K, N, G, w4)
        xo = torch.randn(M, 128, generator=own, device=dev).to(torch.bfloat16)
        wo = (torch.randn(128, N, generator=own, device=dev) * 0.02).to(
            torch.bfloat16)
        a, b = (mix_gemm_a16(x, w, ws, xo, wo, fuse="silu") for _ in "ab")
        torch.cuda.synchronize()
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"mix_gemm_a16 {K}x{N} w4={w4}: two launches differ")
        block.setdefault("bit_equal_launches", []).append(
            dict(K=K, N=N, w4=w4, G=G, plan=a16_plan(M, K, N, w4, G)))
    rows["mix_gemm_a16"] = out_rows + [block]
    # row 5: the w8a16_matmul entry (int8, per-channel, no epilogue)
    K = N = 4096
    ins, wd = a16_inputs(dev, gen, M, K, N, 1, False)
    x, w, ws = ins
    got = w8a16_matmul(x, w, ws)
    torch.cuda.synchronize()
    err = check_a16(got, w8a16_plain(*ins), x, wd, "w8a16_matmul")
    entry = timed_gemm(
        lambda c: w8a16_matmul(x, c, ws), lambda: w8a16_plain(*ins),
        lambda c: torch.matmul(x, c), w, wd, K * N,
        a16_bound(M, K, N, 1, False),
        work=f"w8a16_matmul entry, M={M} K={K} N={N}", mode="W8A16",
        tolerance=A16_TOL, max_abs_err=err, library=A16_LIB,
        plan=a16_plan(M, K, N, False, 1))
    rows["w8a16_matmul"] = [entry]
    return block, entry


def kernel_int8_matmul(dev, gen, rows):
    """Row 6: the int8_matmul_dequant entry onto kernel 2 (W8A8, no
    outliers) at the o_proj shape."""
    from mixq_tpu_torch.kernels.mix_gemm import (int8_matmul_dequant,
                                                 mix_gemm_plain)

    M, K, N = 64, 4096, 4096
    (q_x, w, xs, ws, _, _), lib_w = gemm_inputs(dev, gen, M, K, N, 0)
    got = int8_matmul_dequant(q_x, w, xs, ws)
    torch.cuda.synchronize()
    err = check_gemm(got, mix_gemm_plain(q_x, w, xs, ws),
                     "int8_matmul_dequant")
    row = timed_gemm(
        lambda c: int8_matmul_dequant(q_x, c, xs, ws),
        lambda: mix_gemm_plain(q_x, w, xs, ws),
        lambda c: torch._int_mm(q_x, c), w, lib_w, K * N,
        gemm_bound(M, K, N, 0),
        work=f"int8_matmul_dequant entry, M={M} K={K} N={N}", mode="W8A8",
        tolerance=GEMM_TOL, max_abs_err=err, library=INT_MM,
        plan=mix_plan(M, K, N), **previous("int8_matmul_dequant"))
    rows["int8_matmul_dequant"] = [row]
    return row


def pool_lengths(dev, gen, B, S):
    """A continuous-batching pool's rows: lengths uniform over [1, S], the
    first at S and the second at 1 (a row of one position leaves R - 1
    ranks of a cluster split an empty part), no first slot (a pool row
    starts at 0)."""
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1] = S, 1
    return lengths, torch.zeros(B, dtype=torch.int32, device=dev)


def verify_lengths(dev, gen, B, S, k):
    """A spec pool's rows at the verify's last token: slot_lengths uniform
    over [0, S - k] (the spec round's clamp) plus k, the first row at S
    and the second at k; no first slot."""
    lengths = torch.randint(0, S - k + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32) + k
    lengths[0], lengths[1] = S, k
    return lengths, torch.zeros(B, dtype=torch.int32, device=dev)


def flash_case(dev, gen, B, S, n_q, n_kv, D, int8, offset=0.0, gain=1.0,
               pool=False, verify=0):
    """Random q (N(0, gain^2)) and K/V (N(0, 1)), q and K shifted by
    `offset`, ragged lengths and first slots (`pool`: a CB pool's rows,
    pool_lengths; `verify` = k: a spec pool's rows at the last of k verify
    tokens, verify_lengths)."""
    from mixq_tpu_torch.ops import quant as Q

    q = (torch.randn(B, n_q, D, generator=gen, device=dev) * gain
         + offset).to(torch.bfloat16)
    shape = (1, n_kv, B, S, D)
    kf = torch.randn(shape, generator=gen, device=dev) + offset
    if int8:
        k, ks = Q.quantize_kv(kf)
        v, vs = Q.quantize_kv(torch.randn(shape, generator=gen, device=dev))
    else:
        k = kf.to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
    if verify:
        return (q, k, v, ks, vs) + verify_lengths(dev, gen, B, S, verify)
    if pool:
        return (q, k, v, ks, vs) + pool_lengths(dev, gen, B, S)
    lengths = torch.randint(S // 2, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1] = S, 1
    starts = torch.randint(0, 32, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    starts = torch.minimum(starts, lengths - 1)
    return q, k, v, ks, vs, lengths, starts


def beyond_levels(got, ref, level):
    """(largest |got - ref| beyond two bf16 ulps of |ref|, the same per
    output row in units of that row's probability level, at its largest)."""
    over = ((got.float() - ref.float()).abs()
            - 2 * BF16_ULP * ref.float().abs())
    return over.max().item(), (over.amax(-1) / level).max().item()


def flash_row(dev, gen, B, S, n_q, n_kv, D, int8, softcap=0.0, scale=None,
              offset=0.0, model="Llama-2-7B", gain=1.0, sweep=False,
              alibi=False, pool=False, verify=0):
    """Kernel 3 on one case against its plain version, then timed. The
    limit is two bf16 ulps of |y| plus FLASH_ATOL; for a peaked case
    (gain > 1, or ALiBi, whose rows are peaked by construction) it is two
    ulps plus PEAK_LEVELS of its row's probability level
    (flash_decode_level). With a softcap the case also shows that the cap
    binds: the uncapped plain version lies beyond the limit by a margin;
    with ALiBi (n_q's slopes) the plain version without the bias lies
    beyond it. With `sweep`, the row is also held to its limit and timed
    at every cluster size R (`ms_by_splits`). `pool`: a CB pool's rows
    (pool_lengths); `verify` = k: at the last of k verify tokens
    (verify_lengths)."""
    from mixq_tpu_torch.kernels.flash_decode import (flash_decode_attention,
                                                     flash_decode_level,
                                                     flash_decode_plain)
    from mixq_tpu_torch.models.layers import alibi_slopes
    import torch.nn.functional as F

    from mixq_tpu_torch.kernels import flash_decode as FD
    q, k, v, ks, vs, lengths, starts = flash_case(
        dev, gen, B, S, n_q, n_kv, D, int8, offset, gain, pool, verify)
    args = (q, k, v, lengths, ks, vs, starts, 0)
    slopes = alibi_slopes(n_q, dev) if alibi else None
    opts = dict(softcap=softcap, scale=scale, alibi_slopes=slopes)
    kv = "int8" if int8 else "bf16"
    mode = f"{kv} KV" + (f", softcap {softcap:g}" if softcap else "") + (
        f", scale {scale:.6g}" if scale is not None else "") + (
        f", peaked (q x {gain:g})" if gain != 1 else "") + (
        ", ALiBi" if alibi else "")
    what = f"flash_decode {model} n_q={n_q} n_kv={n_kv} D={D} {mode}"
    got = flash_decode_attention(*args, **opts)
    again = flash_decode_attention(*args, **opts)
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"{what}: two launches of one plan differ")
    ref = flash_decode_plain(*args, **opts).float()
    level = flash_decode_level(*args, **opts)
    plan = flash_plan(B, S, n_q, n_kv, D, int8, softcap)
    err = (got.float() - ref).abs()
    share = ((err - 2 * BF16_ULP * ref.abs()) > 0).float().mean().item()
    by_level = gain != 1 or alibi
    atol, max_levels = FLASH_ATOL[kv], PEAK_LEVELS[kv]
    if by_level:
        tolerance = f"2 bf16 ulps of |y| + {max_levels:g} levels of its row"
    else:
        tolerance = f"2 bf16 ulps of |y| + {atol}"

    def held(out, how):
        """Holds one output of the kernel to the row's limit."""
        beyond, levels = beyond_levels(out, ref, level)
        check(bool(torch.isfinite(out).all())
              and (levels <= max_levels if by_level else beyond <= atol),
              f"{what}{how}: error beyond two bf16 ulps is {beyond} "
              f"({levels} probability levels of its row) > {tolerance}")
        return beyond, levels

    beyond, levels = held(got, "")
    row = {}
    if softcap:
        free = flash_decode_plain(*args, scale=scale,
                                  alibi_slopes=slopes).float()
        (row["uncapped_beyond_2_ulps"],
         row["uncapped_levels"]) = beyond_levels(got, free, level)
        check(row["uncapped_levels"] > 1.5 * max_levels if by_level
              else row["uncapped_beyond_2_ulps"] > 2 * atol,
              f"{what}: the cap does not bind on these inputs")
    if alibi:
        free = flash_decode_plain(*args, softcap=softcap, scale=scale).float()
        (row["unbiased_beyond_2_ulps"],
         row["unbiased_levels"]) = beyond_levels(got, free, level)
        check(row["unbiased_levels"] > 10 * max_levels,
              f"{what}: the bias does not move these rows")
    valid = (lengths - starts).sum().item()
    esize = 1 if int8 else 2
    nbytes = (valid * n_kv * D * esize * 2 + (valid * n_kv * 8 if int8
                                              else 0)
              + 2 * B * n_q * D * 2 + 8 * B)
    # the two dots, and per score the cap's divide, tanh and multiply
    b, by = bound_ms(nbytes, [(4 * valid * n_q * D, kv),
                              (3 * valid * n_q if softcap else 0, "f32")])
    lib = None
    if not int8 and not softcap:
        # SDPA over the same bf16 cache, batch-major, with the same mask
        # (ALiBi: the bias as an additive float mask, -inf where masked)
        kb = k[0].permute(1, 0, 2, 3).contiguous()
        vb = v[0].permute(1, 0, 2, 3).contiguous()
        pos = torch.arange(S, device=dev)
        mask = ((pos[None] < lengths[:, None])
                & (pos[None] >= starts[:, None]))[:, None, None, :]
        if alibi:
            mask = torch.where(mask, slopes[None, :, None, None]
                               * pos.float(), float("-inf"))
        qb = q[:, :, None, :]
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qb, kb, vb, attn_mask=mask, scale=scale), 20)
    rows_of = (f"spec pool rows at the last of {verify} verify tokens: "
               f"lengths {verify} to {S}, no kv_start" if verify
               else f"CB pool rows: lengths 1 to {S}, no kv_start" if pool
               else "ragged lengths and kv_start")
    row.update(mode=mode,
               work=f"{model} B={B} S={S} n_q={n_q} n_kv={n_kv} D={D} "
                    f"{mode}, {rows_of} ({valid} valid rows)"
                    + (f", q and K + {offset:g}" if offset else ""),
               tolerance=tolerance,
               max_abs_err=err.max().item(), beyond_2_ulps=beyond,
               beyond_levels=levels, share_beyond_2_ulps=share,
               ms=device_ms(lambda: flash_decode_attention(*args, **opts), 50),
               plain_ms=device_ms(lambda: flash_decode_plain(*args, **opts),
                                  5),
               library_ms=lib,
               library=("F.scaled_dot_product_attention, bf16"
                        + (", ALiBi as an additive float mask" if alibi
                           else "") if lib
                        is not None else "none: " + (
                            "SDPA has no logit softcap" if softcap
                            else "no PyTorch call attends over int8 K/V")),
               bound_ms=b, bound_by=by, plan=plan)
    if sweep:
        row["ms_by_splits"] = {}
        for R in FD.SPLITS:
            fn = functools.partial(FD._flash, *args, softcap, scale, slopes,
                                   splits=R)
            held(fn(), f" at R = {R}")
            row["ms_by_splits"][R] = device_ms(fn, 50)
    key = (model, n_q, n_kv, D, mode)
    if B == 64 and key in PREV_KERNEL3_MS and not pool:
        row.update(previous_ms=PREV_KERNEL3_MS[key], previous_from="234e8be")
    return row


def flash_plan(B, S, n_q, n_kv, D, int8, softcap):
    """Kernel 3's plan for this call (R, blocks, shared memory), the
    clusters of R blocks the card holds at once, and the ptxas report of
    its instantiation."""
    from mixq_tpu_torch.kernels import _build
    from mixq_tpu_torch.kernels import flash_decode as FD

    g = n_q // n_kv
    clusters = FD._clusters(0, int8, g, softcap > 0, S, D)
    p = FD.plan_flash(B, n_kv, g, S, D, int8, _build.sm_count(0), clusters)
    return dict(splits=p.splits, blocks=p.blocks, smem=p.smem,
                max_active_clusters=clusters[p.splits - 1],
                loads="ring" if FD.uses_ring(g, int8) else "registers",
                **FLASH_PTXAS.get((g, int8, softcap > 0), {}))


def kernel_flash(dev, gen, rows):
    """Kernel 3 at Llama-2-7B's decode shape (MHA int8 and bf16 KV) and
    with GQA 32/8; and at Gemma-2-9B's heads (16/8, D=256) without the
    softcap, the yardstick of the softcap's cost."""
    rows["flash_decode"] = [
        flash_row(dev, gen, 64, 512, n_q, n_kv, D, int8, model=model)
        for model, n_q, n_kv, D, int8 in (
            ("Llama-2-7B", 32, 32, 128, True),
            ("Llama-2-7B", 32, 32, 128, False),
            ("Llama-2-7B", 32, 8, 128, True),
            ("Gemma-2-9B", 16, 8, 256, True))]
    return rows["flash_decode"][0]


def kernel_flash_small_batch(dev, rows):
    """Kernel 3 at generate's batch (B=8) and S=512, where the rows are
    split over clusters: Llama-2-7B int8, the GQA 32/8 int8, Gemma-2-9B
    int8 and bf16 with the softcap, each also timed at R = 1, 2, 4 and 8
    (the inputs from a generator of their own, so the other phases' inputs
    stay as they were)."""
    gen = torch.Generator(device=dev).manual_seed(9)
    rows["flash_decode_b8"] = [
        flash_row(dev, gen, 8, 512, n_q, n_kv, D, int8, cap, scale, offset,
                  model, sweep=True)
        for model, n_q, n_kv, D, int8, cap, scale, offset in (
            ("Llama-2-7B", 32, 32, 128, True, 0.0, None, 0.0),
            ("Llama-2-7B", 32, 8, 128, True, 0.0, None, 0.0),
            ("Gemma-2-9B", 16, 8, 256, True, GEMMA2_SOFTCAP, 256.0 ** -0.5,
             FLASH_OFFSET),
            ("Gemma-2-9B", 16, 8, 256, False, GEMMA2_SOFTCAP, 256.0 ** -0.5,
             FLASH_OFFSET))]


# the served models' attention heads (n_q, n_kv, head_dim, softcap):
# Llama-2-7B, the GQA 32/8 of Mistral-7B, Gemma-2-9B, Gemma-2-27B
FLASH_SHAPES = {"llama": (32, 32, 128, False), "gqa": (32, 8, 128, False),
                "gemma2-9b": (16, 8, 256, True),
                "gemma2-27b": (32, 16, 128, True),
                "baichuan-13b": (40, 40, 128, False)}


# the heads kernel 8 serves (n_q, n_kv, head_dim, softcap): Mistral-7B,
# Llama-2-7B with bf16 KV, Gemma-2-9B under "auto", Baichuan-13B
DECODE_SHAPES = {"mistral": (32, 8, 128, False), "llama": (32, 32, 128, False),
                 "gemma2-9b": (16, 8, 256, True),
                 "baichuan-13b": (40, 40, 128, False)}


# gemma2's attention: the published logit softcap and query_pre_attn_scalar
GEMMA2_SOFTCAP = 50.0
# Spread case: q and K are shifted by 2 in every element, so that each row's
# scores sit at ~43-64 (D * 4 * scale), where the cap of 50 bends them to
# 0.3-0.5x their spread, while the slots keep scores of std ~2 around that:
# the softmax stays spread over many slots, as FLASH_ATOL assumes.
FLASH_OFFSET = 2.0
# Peaked case: q x 3 (scores of std 3 around 0): about a third of a row's
# probability on its top slot and ~14 slots above 1%, as decode attention
# often is. A flipped int8 probability level then moves the row by up to
# flash_decode_level (max|v| * p_scale / l, with l near 1), and a flipped
# bf16 probability by up to 2^-8 * max|v| / l: both more than FLASH_ATOL,
# so such a row is held to PEAK_LEVELS of its own levels. int8 allows a few
# flips: on the CPU the plain version and the Pallas kernel differ by up to
# 2.2 levels there, and a kernel that skips the probability quantization
# by 4.1 or more (tests/test_torch_flash_softcap.py); bf16 allows one.
PEAK_GAIN, PEAK_LEVELS = 3.0, {"int8": 3.0, "bf16": 1.0}


def kernel_flash_softcap(dev, gen, rows):
    """Kernel 3 in gemma2's softcap mode: at Gemma-2-9B's decode shape
    (B=64, S=512, 16/8 heads, D=256; its query_pre_attn_scalar 256 gives
    the default scale, passed explicitly), int8 and bf16 KV, with a spread
    softmax (FLASH_OFFSET) and a peaked one (PEAK_GAIN); and at
    Gemma-2-27B's heads (32/16, D=128) with its non-default score scale
    144^-0.5, int8 KV."""
    rows["flash_decode_softcap"] = [
        flash_row(dev, gen, 64, 512, n_q, n_kv, D, int8, GEMMA2_SOFTCAP,
                  scale, offset, model, gain)
        for model, n_q, n_kv, D, scale, int8, offset, gain in (
            ("Gemma-2-9B", 16, 8, 256, 256.0 ** -0.5, True, FLASH_OFFSET, 1),
            ("Gemma-2-9B", 16, 8, 256, 256.0 ** -0.5, False, FLASH_OFFSET,
             1),
            ("Gemma-2-9B", 16, 8, 256, 256.0 ** -0.5, True, 0, PEAK_GAIN),
            ("Gemma-2-9B", 16, 8, 256, 256.0 ** -0.5, False, 0, PEAK_GAIN),
            ("Gemma-2-27B", 32, 16, 128, 144.0 ** -0.5, True, FLASH_OFFSET,
             1))]
    return rows["flash_decode_softcap"][0]


# the linears of one Gemma-2-9B block at decode (16 q and 8 kv heads of 256,
# H=3584, I=14336): (name, K, N, fuse)
GEMMA2_BLOCK = [("q", 3584, 4096, "none"), ("k", 3584, 2048, "none"),
                ("v", 3584, 2048, "none"), ("o", 4096, 3584, "none"),
                ("up", 3584, 14336, "none"), ("gate", 3584, 14336, "gelu_new"),
                ("down", 14336, 3584, "none")]


def kernel_gemma2_gemms(dev, gen, rows):
    """Every distinct linear shape of a Gemma-2-9B block at decode (M=64):
    kernel 2 (W8A8, 128 outlier channels) on all seven, as the W8A8O16 path
    runs them and as W4A4O16 runs o and down; kernel A (packed W4, A4
    activations) on q, k, v, up and gate+gelu_new, as W4A4O16 runs them;
    kernel B (W8A16) on all seven; and kernel 2 once with the exact gelu,
    which no serve path runs yet. Each is held to its plain version under
    check_gemm's rule and timed over rotated weight copies; up is the gate's
    shape with no epilogue, the yardstick of the epilogue's cost. Returns
    the three gelu_new gate rows."""
    M, Bo = 64, 128
    shapes = sorted({(K, N, f) for _, K, N, f in GEMMA2_BLOCK})
    w4_shapes = sorted({(K, N, f) for n, K, N, f in GEMMA2_BLOCK
                        if n in W4_SLOTS})
    gate = next((K, N, f) for n, K, N, f in GEMMA2_BLOCK if n == "gate")
    w8, _ = gemm_cases(dev, gen, M, Bo, [(K, N, f, False, 1)
                                         for K, N, f in shapes]
                       + [(gate[0], gate[1], "gelu", False, 1)])
    w4, _ = gemm_cases(dev, gen, M, Bo, [(K, N, f, True, 1)
                                         for K, N, f in w4_shapes])
    a16 = [a16_row(dev, gen, M, K, N, f, False, 1, gemm_rule=True)
           for K, N, f in shapes]
    for r in w8 + w4 + a16:
        r["work"] = "Gemma-2-9B, " + r["work"]
    rows["gemma2_mix_gemm"], rows["gemma2_w4"], rows["gemma2_a16"] = (
        w8, w4, a16)
    pick = [shapes.index(gate), w4_shapes.index(gate), shapes.index(gate)]
    return w8[pick[0]], w4[pick[1]], a16[pick[2]]


# the linears of one Baichuan-13B block at decode (40 heads of 128, MHA,
# H=5120, I=13696; q, k and v split from W_pack): (name, K, N, fuse)
BAICHUAN_BLOCK = [("q", 5120, 5120, "none"), ("k", 5120, 5120, "none"),
                  ("v", 5120, 5120, "none"), ("o", 5120, 5120, "none"),
                  ("up", 5120, 13696, "none"),
                  ("gate", 5120, 13696, "silu"),
                  ("down", 13696, 5120, "none")]


def kernel_baichuan(dev, rows):
    """Baichuan-13B's kernels at its decode shapes (the inputs from a
    generator of their own, so the other phases' inputs stay as they were):
    kernel 1 at M=64 H=5120 A8 (past 4096: the looping kernel); kernel 2
    (W8A8) on each distinct linear shape of its block and on the block of
    seven; kernel 3 with ALiBi at B=64 S=512 40/40 D=128, int8 and bf16 KV,
    each held to its plain version at every cluster size R; kernel 8 with
    ALiBi at the same heads, bf16 and int8 KV, at B=64 and at generate's
    B=8 (each held and timed at every R). Returns the kernel-3 int8 row
    (the "flash" path's) and the kernel-8 bf16 row (the "auto" path's,
    with SDPA beside it)."""
    gen = torch.Generator(device=dev).manual_seed(14)
    floor = rows["rmsnorm_quant"][0]["trivial_launch_ms"]
    rows["baichuan_rmsnorm_quant"] = [rmsnorm_row(dev, gen, 64, 5120, 8,
                                                  floor)]
    M, Bo = 64, 128
    shapes = sorted({(K, N, f) for _, K, N, f in BAICHUAN_BLOCK})
    w8, errs = gemm_cases(dev, gen, M, Bo, [(K, N, f, False, 1)
                                            for K, N, f in shapes])
    for r in w8:
        r["work"] = "Baichuan-13B, " + r["work"]
    linears = [(n, K, N, f, False, 1) for n, K, N, f in BAICHUAN_BLOCK]
    blk = gemm_block(
        dev, gen, M, Bo, linears, mode="W8A8", max_abs_err=max(errs),
        work=f"the 7 linears of one Baichuan-13B block at M={M}, {Bo} "
             "outlier channels each (q,k,v,o 5120x5120; up, gate+SiLU "
             "5120x13696; down 13696x5120)", plan=block_plans(M, linears))
    rows["baichuan_mix_gemm"] = w8 + [blk]
    torch.cuda.empty_cache()
    rows["flash_decode_alibi"] = [
        flash_row(dev, gen, 64, 512, 40, 40, 128, int8, model="Baichuan-13B",
                  sweep=True, alibi=True) for int8 in (True, False)]
    rows["decode_attention_alibi"] = [
        decode_row(dev, gen, B, 512, 40, 40, 128, int8, "Baichuan-13B",
                   sweep=B == 8, alibi=True)
        for B, int8 in ((64, False), (64, True), (8, False), (8, True))]
    torch.cuda.empty_cache()
    return rows["flash_decode_alibi"][0], rows["decode_attention_alibi"][0]


def decode_case(dev, gen, B, S, n_q, n_kv, D, int8, offset=0.0, gain=1.0,
                ring=False, pool=False):
    """A batch-major cache layer [B, S, n_kv, D] of N(0, 1) K (+ offset) and
    V, q ~ N(offset, gain^2). Ragged lengths and first positions (`pool`: a
    CB pool's rows, pool_lengths); a ring is read past its wrap (the first
    row at S + 37) from the window start of a window of S, as Mistral's
    4096-slot ring is."""
    from mixq_tpu_torch.ops import quant as Q

    q = (torch.randn(B, n_q, D, generator=gen, device=dev) * gain
         + offset).to(torch.bfloat16)
    shape = (B, S, n_kv, D)
    kf = torch.randn(shape, generator=gen, device=dev) + offset
    vf = torch.randn(shape, generator=gen, device=dev)
    if int8:
        (k, ks), (v, vs) = Q.quantize_kv(kf), Q.quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    del kf, vf
    if ring:
        lengths = torch.randint(S + 1, 2 * S, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[0] = S + 37
        starts = (lengths - S).to(torch.int32)
    elif pool:
        lengths, starts = pool_lengths(dev, gen, B, S)
    else:
        lengths = torch.randint(S // 2, S + 1, (B,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = S, 1
        starts = torch.minimum(
            torch.randint(0, 32, (B,), generator=gen, device=dev,
                          dtype=torch.int32), lengths - 1)
    hi = lengths if ring else torch.clamp_max(lengths, S)
    lo = torch.clamp_min(starts, 0)
    if ring:
        lo = torch.maximum(lo, lengths - S)
    valid = int(torch.clamp_min(hi - lo, 0).sum().item())
    return (q, k, v, lengths, ks, vs, starts), valid


def decode_row(dev, gen, B, S, n_q, n_kv, D, int8, model, softcap=0.0,
               scale=None, offset=0.0, gain=1.0, ring=False, sweep=False,
               cpu_ref=False, alibi=False, pool=False):
    """Kernel 8 on one case against its plain version (two bf16 ulps of |y|
    plus DECODE_ATOL), two launches of its plan bit-equal, then timed; with a
    softcap the uncapped plain version lies beyond the limit, and with
    `cpu_ref` the kernel is also held to the plain version run on a CPU copy
    of the inputs. The library call, for bf16 KV without softcap or ring, is
    SDPA (enable_gqa) over the same cache with the same mask. With `sweep`
    the row is also held to its limit and then timed at every cluster size
    R (`ms_by_splits`). With ALiBi (n_q's slopes) the plain version without
    the bias lies beyond the limit, and SDPA takes the bias as an additive
    float mask. Each row carries its plan (R, blocks, the card's clusters
    of R, the load pipeline, ptxas registers and spills). `pool`: a CB
    pool's rows (pool_lengths)."""
    from mixq_tpu_torch.kernels import _build
    from mixq_tpu_torch.kernels import decode_attention as DA
    from mixq_tpu_torch.kernels.decode_attention import (
        DECODE_ATOL, decode_attention, decode_attention_plain)
    from mixq_tpu_torch.models.layers import alibi_slopes
    import torch.nn.functional as F

    args, valid = decode_case(dev, gen, B, S, n_q, n_kv, D, int8, offset,
                              gain, ring, pool)
    slopes = alibi_slopes(n_q, dev) if alibi else None
    opts = dict(ring=ring, softcap=softcap, scale=scale, alibi_slopes=slopes)
    kv = "int8" if int8 else "bf16"
    mode = f"{kv} KV" + (", ring past the wrap" if ring else "") + (
        f", softcap {softcap:g}" if softcap else "") + (
        f", scale {scale:.6g}" if scale is not None else "") + (
        f", peaked (q x {gain:g})" if gain != 1 else "") + (
        ", ALiBi" if alibi else "")
    what = (f"decode_attention {model} B={B} n_q={n_q} n_kv={n_kv} D={D} "
            f"{mode}")
    got = decode_attention(*args, **opts)
    again = decode_attention(*args, **opts)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{what}: two launches of one plan differ")
    ref = decode_attention_plain(*args, **opts).float()

    def held(out, ref, how):
        """Holds one output of the kernel to the row's limit."""
        over = (out.float() - ref).abs() - 2 * BF16_ULP * ref.abs()
        beyond = over.max().item()
        check(beyond <= DECODE_ATOL and bool(torch.isfinite(out).all()),
              f"{what}{how}: error {beyond} beyond two bf16 ulps > "
              f"{DECODE_ATOL}")
        return beyond, over

    beyond, over = held(got, ref, "")
    err = (got.float() - ref).abs()
    row = {}
    if cpu_ref:
        cpu_args = tuple(x.cpu() if torch.is_tensor(x) else x for x in args)
        row["beyond_2_ulps_cpu_plain"] = held(
            got.cpu(), decode_attention_plain(*cpu_args, **opts).float(),
            " against the plain version on the CPU")[0]
    if softcap:
        free = decode_attention_plain(*args, ring=ring, scale=scale).float()
        row["uncapped_beyond_2_ulps"] = (
            (got.float() - free).abs() - 2 * BF16_ULP * free.abs()
        ).max().item()
        check(row["uncapped_beyond_2_ulps"] > 10 * DECODE_ATOL,
              f"{what}: the cap does not bind on these inputs")
    if alibi:
        free = decode_attention_plain(*args, ring=ring, scale=scale).float()
        row["unbiased_beyond_2_ulps"] = (
            (got.float() - free).abs() - 2 * BF16_ULP * free.abs()
        ).max().item()
        check(row["unbiased_beyond_2_ulps"] > 10 * DECODE_ATOL,
              f"{what}: the bias does not move these rows")
    esize = 1 if int8 else 2
    nbytes = (valid * n_kv * D * esize * 2 + (valid * n_kv * 8 if int8
                                              else 0)
              + 2 * B * n_q * D * 2 + 8 * B)
    # f32 operations: the widened recipe's two dots, per score the cap's
    # divide, tanh and multiply
    b, by = bound_ms(nbytes, [(4 * valid * n_q * D, "f32"),
                              (3 * valid * n_q if softcap else 0, "f32")])
    lib = None
    if not int8 and not softcap and not ring:
        q, k, v, lengths, _, _, starts = args
        pos = torch.arange(S, device=dev)
        mask = ((pos[None] < lengths[:, None])
                & (pos[None] >= starts[:, None]))[:, None, None, :]
        if alibi:                      # attend's relative form
            dist = (pos[None] - (lengths[:, None] - 1)).float()
            mask = torch.where(mask, slopes[None, :, None, None]
                               * dist[:, None, None, :], float("-inf"))
        kt, vt, qb = k.transpose(1, 2), v.transpose(1, 2), q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qb, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
        row["library_max_abs_diff"] = (sdpa()[:, :, 0].float()
                                       - ref).abs().max().item()
        lib = device_ms(sdpa, 20)
    g = n_q // n_kv
    clusters = DA._clusters(0, int8, g, softcap > 0, D)
    plan = DA.plan_decode(B, n_kv, g, S, D, int8, softcap > 0,
                          _build.sm_count(0), clusters)
    rows_of = (f"CB pool rows: lengths 1 to {S}, no kv_start" if pool
               else "ragged lengths and starts")
    row.update(mode=mode,
               work=f"{model} B={B} S={S} n_q={n_q} n_kv={n_kv} D={D} "
                    f"{mode}, {rows_of} ({valid} valid rows)"
                    + (f", q and K + {offset:g}" if offset else ""),
               tolerance=f"2 bf16 ulps of |y| + {DECODE_ATOL}",
               max_abs_err=err.max().item(), beyond_2_ulps=beyond,
               share_beyond_2_ulps=(over > 0).float().mean().item(),
               ms=device_ms(lambda: decode_attention(*args, **opts), 50),
               plain_ms=device_ms(lambda: decode_attention_plain(*args,
                                                                 **opts), 5),
               library_ms=lib,
               library=("F.scaled_dot_product_attention, bf16, enable_gqa, "
                        + ("ALiBi as an additive float mask" if alibi
                           else "boolean mask")
                        if lib is not None else "none: " + (
                            "SDPA has no logit softcap" if softcap
                            else "SDPA takes no ring positions" if ring
                            and not int8 else "SDPA takes no per-token K/V "
                            "scales")),
               bound_ms=b, bound_by=by,
               plan=dict(splits=plan.splits, blocks=plan.blocks,
                         stage_rows=plan.stage,
                         smem=DA.launch_smem(int8, g, D),
                         max_active_clusters=clusters[plan.splits - 1],
                         loads="cp.async ring (csrc/decode_attention.cu::"
                               "stages)",
                         **DECODE_PTXAS.get((g, int8, softcap > 0), {})))
    if sweep:
        row["ms_by_splits"] = {}
        for R in DA.SPLITS:
            fn = functools.partial(DA._decode, *args, ring, scale, softcap,
                                   slopes, splits=R)
            held(fn(), ref, f" at R = {R}")
            row["ms_by_splits"][R] = device_ms(fn, 50)
    key = (model, n_q, n_kv, D, mode, B)
    if key in PREV_KERNEL8_MS and not pool:
        row.update(previous_ms=PREV_KERNEL8_MS[key], previous_from="171275c")
    return row


def kernel_decode_attention(dev, gen, rows):
    """Kernel 8 at the decode shapes of the batch-major paths: Mistral-7B's
    heads (32/8, int8; spread, and peaked with q x 3), Llama-2-7B's with
    bf16 KV (32/32), Mistral's 4096-slot ring at B=16 read past its wrap,
    and Gemma-2-9B's (16/8, D=256) with the softcap and its scale, as
    gemma2 runs under "auto" (also held to the plain version on a CPU copy
    of its inputs). Returns the Llama bf16 row (the one with a library
    call)."""
    rows["decode_attention"] = [
        decode_row(dev, gen, 64, 512, 32, 8, 128, True, "Mistral-7B"),
        decode_row(dev, gen, 64, 512, 32, 32, 128, False, "Llama-2-7B"),
        decode_row(dev, gen, 16, 4096, 32, 8, 128, True, "Mistral-7B",
                   ring=True),
        decode_row(dev, gen, 64, 512, 16, 8, 256, True, "Gemma-2-9B",
                   GEMMA2_SOFTCAP, 256.0 ** -0.5, FLASH_OFFSET, cpu_ref=True),
        decode_row(dev, gen, 64, 512, 32, 8, 128, True, "Mistral-7B",
                   gain=PEAK_GAIN)]
    torch.cuda.empty_cache()
    return rows["decode_attention"][1]


def kernel_decode_small_batch(dev, rows):
    """Kernel 8 at generate's batch (B=8) and S=512, where the plan may
    split the rows over clusters: Mistral-7B's int8 heads and Llama-2-7B's
    bf16 heads, each held to its limit and timed at R = 1, 2, 4 and 8 (the
    inputs from a generator of their own, so the other phases' inputs stay
    as they were)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    rows["decode_attention_b8"] = [
        decode_row(dev, gen, 8, 512, 32, 8, 128, True, "Mistral-7B",
                   sweep=True),
        decode_row(dev, gen, 8, 512, 32, 32, 128, False, "Llama-2-7B",
                   sweep=True)]


def kernel_pool_rows(dev, rows):
    """Kernels 3 and 8 at the rows of phase 9's pools (64 slots of 640
    positions at Llama-2-7B's heads): kernel 3 with int8 KV (head-major),
    kernel 8 with bf16 KV (batch-major), lengths 1 to S with a row at 1 and
    one at S in one launch, each held to its limit and timed at every
    cluster size R (the inputs from a generator of their own, so the other
    phases' inputs stay as they were). Returns (kernel 3's row, kernel
    8's)."""
    gen = torch.Generator(device=dev).manual_seed(15)
    rows["cb_pool"] = [
        flash_row(dev, gen, CB_SLOTS, CB_SEQ, 32, 32, 128, True,
                  sweep=True, pool=True),
        decode_row(dev, gen, CB_SLOTS, CB_SEQ, 32, 32, 128, False,
                   "Llama-2-7B", sweep=True, pool=True)]
    torch.cuda.empty_cache()
    return tuple(rows["cb_pool"])


# ---------------------------------------------------------------------------
# Phases 4-6
# ---------------------------------------------------------------------------

def llama2_7b():
    from mixq_tpu_torch import presets

    return presets.llama2_7b()


def gemma2_9b():
    from mixq_tpu_torch import presets

    return presets.gemma2_9b()


def baichuan_13b():
    from mixq_tpu_torch import presets

    return presets.baichuan_13b()


def mistral_7b():
    from mixq_tpu_torch import presets

    return presets.mistral_7b()


def tiny_mistral():
    """tests/test_torch_mistral.py's mistral at phase 4's tiny widths: a
    window of 4 on a ring of 8 slots (tests/test_kv_cache.py:110-118)."""
    from mixq_tpu_torch.config import ModelConfig

    return ModelConfig.tiny(model_type="mistral", sliding_window=4,
                            hidden_size=256, intermediate_size=512,
                            num_attention_heads=4, num_key_value_heads=2)


def tiny_gemma2():
    """tests/test_torch_gemma2.py's gemma2 fields at phase 4's tiny widths,
    a window no shorter than the cache, and caps that bind without
    saturating: about three times the typical value on the seeded tiny
    models (|score| averages 0.13, at most 0.57; |logit| 0.25, at most
    1.5), so the attention cap is 0.4 and the final cap 1.0."""
    from mixq_tpu_torch.config import ModelConfig

    return ModelConfig.tiny(
        model_type="gemma2", hidden_size=256, intermediate_size=512,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh", gated_mlp=True,
        tie_word_embeddings=True, embed_multiplier=256 ** 0.5,
        post_norms=True, query_pre_attn_scalar=24.0, attn_logit_softcap=0.4,
        final_logit_softcap=1.0, sliding_window=128,
        sliding_window_pattern=2)


def tiny_baichuan():
    """tests/test_torch_gpu.py's ALiBi llama-shaped model at phase 4's tiny
    widths: 6 heads of 64 (slopes of a head count that is not a power of
    two), MHA as Baichuan, rope style "none"."""
    from mixq_tpu_torch.config import ModelConfig

    return ModelConfig.tiny(model_type="baichuan", alibi=True,
                            rope_style="none", hidden_size=384,
                            intermediate_size=512, num_attention_heads=6,
                            num_key_value_heads=6)


# launches per layer and forward of each configuration's linears, by weight
# mode (kernels.launch_counts keys); the gate GEMM adds one of its epilogue
# (silu, or gemma2's gelu_new), the decode attention one per layer and decode
# step in each of its modes (attn_modes), and every other count stays 0
PER_LAYER = {
    "W8A8": {"rmsnorm_quant": 2, "mix_gemm": 7, "mix_gemm.w8a8": 7},
    "W4A4": {"rmsnorm_quant": 2, "mix_gemm": 7, "mix_gemm.w4": 5,
             "mix_gemm.w8a8": 2},
    "W4A4 grouped": {"rmsnorm_quant": 2, "mix_gemm": 7,
                     "mix_gemm.w4_grouped": 5, "mix_gemm.w8a8_grouped": 2},
    "W8A16": {"w8a16": 7, "w8a16.w8": 7},
    # QUIK: every linear quantizes its own fp input (no kernel 1)
    "QUIK": {"mix_gemm": 7, "mix_gemm.w4_zp": 5, "mix_gemm.w8a8_zp": 2},
}


def path_specs(name, attn_impl="auto", group_size=128, outlier_budget=128):
    """The DecoderSpecs of a configuration: W8A8 on every linear, or the
    reference policy of quantize.resolve_specs (W4A4: q/k/v/up/gate W4A4,
    o/down W8A8; W8A16: weight-only everywhere; QUIK: q/k/v/up/gate QUIK
    W4A4, o/down QUIK W8A8), with its attn_impl."""
    import dataclasses

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.decoder import DecoderSpecs
    from mixq_tpu_torch.ops.mixed_linear import LinearSpec
    from mixq_tpu_torch.quantize import resolve_specs

    if name == "W8A8":
        specs = DecoderSpecs.uniform(LinearSpec(w_bit=8, a_bit=8))
    elif name == "W8A16":
        specs = resolve_specs(QuantConfig.w8a16())
    elif name == "QUIK":
        specs = resolve_specs(QuantConfig.quik_w4a4())
    else:
        specs = resolve_specs(QuantConfig.w4a4(
            outlier_budget=outlier_budget,
            q_group_size=group_size if name == "W4A4 grouped" else -1))
    return dataclasses.replace(specs, attn_impl=attn_impl)


def attn_modes(cfg, specs, kv_dtype, max_seq):
    """The decode attention's launch-count keys, one launch each per layer
    and decode step, on the cache layout the engine's policy gives: kernel 3
    (flash_decode, in its softcap mode for gemma2, its ALiBi mode for an
    ALiBi model) on the head-major cache, kernel 8 (decode_attention, by
    KV type, ring for a uniform window, softcap, ALiBi) on the batch-major
    one."""
    from mixq_tpu_torch.kernels.flash_decode import use_head_major_cache

    itemsize = 1 if kv_dtype == "int8" else 2
    cap = bool(cfg.attn_logit_softcap)
    if use_head_major_cache(specs.attn_impl, cfg, max_seq, itemsize):
        return (["flash_decode"] + (["flash_decode.softcap"] if cap else [])
                + (["flash_decode.alibi"] if cfg.alibi else []))
    ring = cfg.sliding_window is not None and cfg.sliding_window_pattern == 1
    return (["decode_attention", "decode_attention."
             + ("int8" if kv_dtype == "int8" else "bf16")]
            + (["decode_attention.ring"] if ring else [])
            + (["decode_attention.softcap"] if cap else [])
            + (["decode_attention.alibi"] if cfg.alibi else []))


def expect_launches(name, cfg, forwards, decode_steps, attn):
    from mixq_tpu_torch.models.decoder import GATE_FUSE

    L = cfg.num_hidden_layers
    gate = ("w8a16" if name == "W8A16" else "mix_gemm") + "." + GATE_FUSE[
        cfg.hidden_act]
    want = {k: v * L * forwards
            for k, v in {**PER_LAYER[name], gate: 1}.items()}
    want.update({k: L * decode_steps for k in attn})
    return want


def check_launches(counts, want, what):
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{what}: launch counts {got} != {want}")


def ran_on_card(prof):
    """The port's kernels the card ran in the block of a card_trace window
    (kernels.block_events), by launch-count key, read from the kernel
    names of its device events (kernels.executed_counts)."""
    from mixq_tpu_torch.kernels import block_events, executed_counts

    return executed_counts((e.name, 1) for e in block_events(prof))


def check_executed(ran, want, what):
    """`ran` (ran_on_card) against launch counts `want` on the keys a
    kernel's name shows."""
    from mixq_tpu_torch.kernels import UNNAMED

    check_launches(ran, {k: v for k, v in want.items() if k not in UNNAMED},
                   f"{what} (kernels the card ran)")


# tiny model card vs CPU: max |dlogits| over max |logits|, per family and
# configuration. Each limit lies between what the card reads (the larger of
# bf16 and int8 KV) and the control, the same CPU model with int8 KV
# against bf16 KV; the check asserts the control on every run, so a card
# path that lost as much precision as an int8 KV cache would fail. The
# controls on an H100: llama W8A8 1.9e-2, W4A4 7.9e-2, W4A4 grouped 6.5e-2,
# W8A16 7.1e-3; gemma2 W8A8 4.0e-2, W4A4 1.36e-1, W8A16 1.3e-2; on the
# batch-major cache llama W8A8 1.73e-2, mistral ring 1.96e-2. With every
# quantizer dividing in IEEE f32 on the card as on the CPU, the card's run
# of a W8A8 or W4A4 model equals the CPU's block by block (at most 4.5e-7
# of max|logits|, llama batch-major int8 KV included); W8A16 reads 3.6e-3
# (llama) and 4.3e-3 (gemma2), where the a16 GEMM sums in another order,
# llama batch-major with bf16 KV 1.07e-2 and the mistral ring 8.1e-3, where
# kernel 8 sums in another order. The tiny ALiBi model (baichuan) takes
# the llama limits of its layout: 1e-5 under "flash", 1.35e-2 batch-major.
# When the card's quantizers multiplied by
# the reciprocal, the card left the CPU in the prefill by one bf16 ulp of a
# block's output and read up to 5.4e-3 (llama W8A8), 3.4e-2 (W4A4), 1.7e-2
# (gemma2 W8A8), 7.2e-2 (gemma2 W4A4) and, with 39 int8 KV entries written
# differently, 1.06e-2 (llama batch-major int8 KV). So the W8A8 and W4A4
# limits on the head-major cache are 1e-5, about 20x the card's reading: a
# quantizer that rounds apart from the CPU's again fails them. The tiny
# QUIK llama takes the W4A4 limit: its asymmetric quantizer
# divides in IEEE f32 on both devices too.
TINY_TOL = {
    ("llama", "W8A8"): 1e-5, ("llama", "W4A4"): 1e-5, ("llama", "QUIK"): 1e-5,
    ("llama", "W4A4 grouped"): 1e-5, ("llama", "W8A16"): 5e-3,
    ("gemma2", "W8A8"): 1e-5, ("gemma2", "W4A4"): 1e-5,
    ("gemma2", "W8A16"): 8e-3,
    ("llama batch-major", "W8A8"): 1.35e-2, ("mistral ring", "W8A8"): 1e-2,
    ("baichuan", "W8A8"): 1e-5, ("baichuan batch-major", "W8A8"): 1.35e-2}


class Tap:
    """Records a forward pass layer by layer: each block's output and each
    decode-step attention output (to the host), and on the card, for each
    decode attention launch (kernel 3 or 8), the kernel's distance from its
    plain version on the same inputs: beyond two bf16 ulps, absolute and,
    for kernel 3, in probability levels of its row. Used as `with Tap() as
    tap:` around the engine's calls."""

    def __enter__(self):
        from mixq_tpu_torch.kernels.decode_attention import (
            decode_attention_plain)
        from mixq_tpu_torch.kernels.flash_decode import (flash_decode_level,
                                                         flash_decode_plain)
        from mixq_tpu_torch.models import decoder as D

        self.blocks, self.attn, self.kernel = [], [], []
        self._D = D
        self._real = (D.flash_decode_attention, D.decode_attention,
                      D.block_core)
        real_fd, real_da, real_bc = self._real

        def fd(*a, **kw):
            out = real_fd(*a, **kw)
            self.attn.append(out.float().cpu())
            if out.is_cuda:
                b, lv = beyond_levels(out, flash_decode_plain(*a, **kw),
                                      flash_decode_level(*a, **kw))
                self.kernel.append(dict(kernel="flash_decode", beyond=b,
                                        levels=lv))
            return out

        def da(*a, **kw):
            out = real_da(*a, **kw)
            self.attn.append(out.float().cpu())
            if out.is_cuda:
                ref = decode_attention_plain(*a, **kw).float()
                self.kernel.append(dict(
                    kernel="decode_attention",
                    beyond=((out.float() - ref).abs()
                            - 2 * BF16_ULP * ref.abs()).max().item()))
            return out

        def bc(*a, **kw):
            x = real_bc(*a, **kw)
            self.blocks.append(x.float().cpu())
            return x
        D.flash_decode_attention, D.decode_attention, D.block_core = (
            fd, da, bc)
        return self

    def __exit__(self, *exc):
        (self._D.flash_decode_attention, self._D.decode_attention,
         self._D.block_core) = self._real
        return False

    def worst(self, kernel, by="beyond"):
        """The launch of `kernel` farthest beyond two ulps of its plain
        version, absolute or (by="levels", kernel 3) in probability levels
        (None if it never launched)."""
        runs = [r for r in self.kernel if r["kernel"] == kernel]
        return max(runs, key=lambda r: r[by], default=None)


def first_divergence(cpu, card, L, prefills):
    """Where the card's run first leaves the CPU's: the first (forward,
    layer) whose block output differs, whether the decode-step attention
    output of that layer already differs, and the kernel's distance from its
    plain version at that launch."""
    for i, (a, b) in enumerate(zip(cpu.blocks, card.blocks)):
        d = (a - b).abs().max().item()
        if d == 0:
            continue
        f, layer = divmod(i, L)
        out = dict(forward=f, layer=layer, block_max_abs_diff=d)
        if f >= prefills:               # a decode step: attention by kernel
            j = (f - prefills) * L + layer
            out["attention_max_abs_diff"] = (
                cpu.attn[j] - card.attn[j]).abs().max().item()
            out["kernel"] = card.kernel[j]
        return out
    return None


def teacher_forced(eng, toks, kv_start, slots, prefill):
    """Prefill in chunks of the given lengths, then one decode step for each
    remaining token, fed the given tokens, on a cache of `slots` slots: the
    logits [steps, B, V] on the host and the cache."""
    cache = eng.new_cache(toks.shape[0], slots)
    steps, p = [], 0
    for n in prefill:
        logits, cache = eng.prefill(toks[:, p:p + n], cache, kv_start)
        steps.append(logits.float().cpu())
        p += n
    for i in range(p, toks.shape[1]):
        logits, cache = eng.decode_step(toks[:, i:i + 1], cache, kv_start)
        steps.append(logits.float().cpu())
    return torch.stack(steps), cache


def reference_check(dev):
    """Tiny models (seeded outliers on every MIX linear input) on the card
    through the kernels against the same models on the CPU through their
    plain versions, bf16 and int8 KV: teacher-forced logits within
    TINY_TOL * max|logits|, each limit below the CPU's int8-vs-bf16 KV
    control; every decode attention launch within its plain version's
    limit on the model's own inputs; every launch count by mode; and where
    the card's run first leaves the CPU's (Tap). On the head-major cache
    (attn_impl="flash", kernel 3; a prefill of 8 and 4 decode steps on 128
    slots): llama in W8A8, W4A4 per-channel and with 64-row groups (a
    divisor of the tiny K/2 = 128 and 256), W8A16 and QUIK W4A4 (the
    zero-point modes); gemma2 in W8A8, W4A4
    and W8A16. On the batch-major cache under attn_impl="auto" (kernel 8):
    llama W8A8 on 64 slots (a prefill of 8, 4 decode steps), and mistral
    W8A8 with a window of 4 on a ring of 8 slots (a prefill in two chunks of
    4, then 12 decode steps: the ring wraps twice). Every configuration runs
    before the checks, so a failing one still shows the others' numbers."""
    from mixq_tpu_torch.config import EngineConfig, ModelConfig
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.kernels.decode_attention import DECODE_ATOL
    from mixq_tpu_torch.models.decoder import init_decoder_params

    llama = ModelConfig.tiny(hidden_size=256, intermediate_size=512,
                             num_attention_heads=4, num_key_value_heads=2)
    toks, long = (torch.randint(1, llama.vocab_size, (3, n),
                                generator=torch.Generator().manual_seed(1))
                  for n in (12, 20))
    kv_start = torch.tensor([0, 2, 5], dtype=torch.int32)
    short = (toks, 128, [8])                  # 8 + 4 steps on 128 slots
    runs_of = (
        [("llama", llama, n, "flash", short) for n in PER_LAYER]
        + [("gemma2", tiny_gemma2(), n, "flash", short)
           for n in ("W8A8", "W4A4", "W8A16")]
        + [("llama batch-major", llama, "W8A8", "auto", (toks, 64, [8])),
           ("mistral ring", tiny_mistral(), "W8A8", "auto",
            (long, 8, [4, 4])),
           ("baichuan", tiny_baichuan(), "W8A8", "flash", short),
           ("baichuan batch-major", tiny_baichuan(), "W8A8", "auto",
            (toks, 64, [8]))])
    res, failures = {}, []
    for family, cfg, name, attn_impl, (tk, slots, prefill) in runs_of:
        specs = path_specs(name, attn_impl, group_size=64, outlier_budget=16)
        cpu = init_decoder_params(cfg, specs, torch.Generator().manual_seed(0),
                                  device="cpu", outlier_budget=16)
        card = params_to(cpu, dev)
        L = cfg.num_hidden_layers
        ref = {}
        for kv_dtype in ("bfloat16", "int8"):
            ecfg = EngineConfig(max_seq_len=64, prefill_chunk=8,
                                kv_dtype=kv_dtype)
            reset_launch_counts()
            runs = []
            for params, d in ((cpu, "cpu"), (card, dev)):
                eng = InferenceEngine(params, cfg, specs, ecfg, device=d)
                with Tap() as tap:
                    logits, cache = teacher_forced(eng, tk, kv_start, slots,
                                                   prefill)
                runs.append((logits, cache, tap))
            counts = launch_counts()
            (ref[kv_dtype], c_cpu, t_cpu), (got, c_card, t_card) = runs
            scale = ref[kv_dtype].abs().max().item()
            err = (got - ref[kv_dtype]).abs().max().item()
            tol = TINY_TOL[family, name] * scale
            kv_diff = sum(int((a.cpu() != b.cpu()).sum()) for a, b in (
                (c_cpu.k, c_card.k), (c_cpu.v, c_card.v)))
            key = f"{family} {name} {kv_dtype} KV"
            attn = attn_modes(cfg, specs, kv_dtype, slots)
            res[key] = dict(
                max_abs_err=err, share_of_max=err / scale, tolerance=tol,
                shape=list(got.shape), head_major=c_card.head_major,
                kv_cache_entries_differing=kv_diff,
                first_divergence=first_divergence(t_cpu, t_card, L,
                                                  len(prefill)))
            if not (bool(torch.isfinite(got).all()) and err <= tol):
                failures.append(f"tiny {key} card vs CPU: max |dlogits| "
                                f"{err} > {tol}")
            kv = "int8" if kv_dtype == "int8" else "bf16"
            # kernel 3's ALiBi rows are peaked: held in probability levels
            for kernel, limit, by in (
                    ("flash_decode", PEAK_LEVELS[kv], "levels") if cfg.alibi
                    else ("flash_decode", FLASH_ATOL[kv], "beyond"),
                    ("decode_attention", DECODE_ATOL, "beyond")):
                worst = t_card.worst(kernel, by)
                if worst is None:
                    continue
                res[key][f"{kernel}_worst_launch"] = worst
                if worst[by] > limit:
                    failures.append(f"tiny {key}: a {kernel} launch is "
                                    f"{worst[by]} ({by}) beyond two ulps "
                                    "of its plain version")
            steps = tk.shape[1] - sum(prefill)
            want = expect_launches(name, cfg, len(prefill) + steps, steps,
                                   attn)
            if {k: v for k, v in counts.items() if v} != want:
                failures.append(f"tiny {key}: launches {counts} != {want}")
        # the control: what int8 KV moves on the same CPU model
        control = ((ref["int8"] - ref["bfloat16"]).abs().max().item()
                   / ref["bfloat16"].abs().max().item())
        res[f"{family} {name} control"] = control
        if not TINY_TOL[family, name] < control:
            failures.append(f"tiny {family} {name}: limit "
                            f"{TINY_TOL[family, name]} of max|logits| is not "
                            f"below the int8-vs-bf16 KV control {control}")
    print(f"reference: tiny models card vs CPU, teacher-forced logits {res}",
          flush=True)
    check(not failures, "; ".join(failures))
    return res


# the seed of phase 4's CB script (prompts and budgets), not picked for
# its margins: the check asserts tokens only before a near-tie
CB_TINY_SEED = 15
# phase 4's CB limit on teacher-forced logits, both layouts: below the
# llama W8A8 int8-vs-bf16 KV controls (1.73e-2 batch-major, 1.9e-2
# head-major). A bf16 ulp that kernel 3 or 8 leaves from its plain version
# can flip an int8 activation or KV entry, and a flip moves the logits by
# ~1e-2 of their max: on an H100, over seeds 0-15 of this script and of
# tests/test_torch_gpu.py's CB script, both layouts read up to 1.40e-2
# where an entry flips and ~3e-7 where none does (cb_seed_scan.py)
CB_TINY_TOL = 1.6e-2


def cb_reference(dev, seed=CB_TINY_SEED):
    """Phase 4's continuous-batching check: the tiny W8A8 llama served by
    the CB engine (10 requests of 1 to 19 prompt tokens, budgets 4 to 13,
    on 4 slots of 64 positions, int8 KV, windows of 8) on the card, through
    the kernels and graph replays, and on the CPU, under "flash" (head-
    major, kernel 3) and "auto" (at 64 positions batch-major, kernel 8).
    Each request's CPU tokens are then replayed teacher-forced as the pool
    serves them (its prompt but the last token, then one token a step) on
    both devices: every step's logits within CB_TINY_TOL of max|logits|
    on both layouts, and the card's served tokens equal to the CPU's up
    to the request's first step whose top-2 margin (the CPU's logits) does
    not clear twice that step's card-vs-CPU gap: before it the two argmaxes
    must agree, from it on a near-tie may go either way."""
    from mixq_tpu_torch.config import EngineConfig, ModelConfig
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
    from mixq_tpu_torch.models.decoder import init_decoder_params

    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2)
    g = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in torch.randint(1, 20, (10,), generator=g).tolist()]
    budgets = [4 + i for i in range(10)]
    ecfg = EngineConfig(max_batch_size=4, max_seq_len=64, prefill_chunk=8,
                        kv_dtype="int8")
    res = {}
    for attn_impl in ("flash", "auto"):
        specs = path_specs("W8A8", attn_impl, outlier_budget=16)
        cpu = init_decoder_params(cfg, specs,
                                  torch.Generator().manual_seed(0),
                                  device="cpu", outlier_budget=16)
        card = params_to(cpu, dev)
        served = []
        for params, d in ((cpu, "cpu"), (card, dev)):
            eng = ContinuousBatchingEngine(params, cfg, specs, ecfg,
                                           device=d)
            ids = [eng.add_request(p, b) for p, b in zip(prompts, budgets)]
            out = eng.run_to_completion()
            served.append([out[i] for i in ids])
        hm = eng.cache.head_major
        check(hm == (attn_impl == "flash"), f"CB tiny {attn_impl}: layout")
        tol = CB_TINY_TOL
        worst, held, ties, margin = 0.0, 0, [], float("inf")
        for r, (prompt, toks, got_toks) in enumerate(zip(prompts, *served)):
            logits = []
            for params, d in ((cpu, "cpu"), (card, dev)):
                eng = InferenceEngine(params, cfg, specs, ecfg, device=d)
                cache = eng.new_cache(1, 64)
                if len(prompt) > 1:
                    eng.prefill(torch.tensor([prompt[:-1]]), cache)
                steps = []
                for t in [prompt[-1]] + toks[:-1]:
                    lg, cache = eng.decode_step(torch.tensor([[t]]), cache)
                    steps.append(lg[0].float().cpu())
                logits.append(torch.stack(steps))
            ref, got = logits
            gaps = (got - ref).abs().amax(-1)
            worst = max(worst, gaps.max().item() / ref.abs().max().item())
            top2 = torch.topk(ref, 2, dim=-1).values
            margins = top2[:, 0] - top2[:, 1]
            margin = min(margin, margins.min().item())
            near = (margins <= 2 * gaps).nonzero()
            n = int(near[0]) if len(near) else len(toks)
            check(got_toks[:n] == toks[:n], f"CB tiny {attn_impl}: request "
                  f"{r}'s card tokens {got_toks} leave the CPU's {toks} "
                  f"before its first near-tie (step {n})")
            held += n
            if n < len(toks):
                ties.append(dict(request=r, step=n,
                                 margin=margins[n].item(),
                                 gap=gaps[n].item()))
        check(worst <= tol, f"CB tiny {attn_impl}: teacher-forced logits "
              f"{worst} of max|logits| from the CPU's, past {tol}")
        tokens = sum(len(t) for t in served[0])
        res[f"llama W8A8 CB {attn_impl} int8 KV"] = dict(
            head_major=hm, requests=len(prompts), tokens=tokens,
            tokens_held_equal=held, tokens_equal=served[0] == served[1],
            near_ties=ties, max_logits_gap=worst, limit=tol,
            min_top2_margin=margin)
    print(f"reference: CB engine, tiny llama card vs CPU {res}", flush=True)
    return res


def new_engine(dev, params, cfg, specs, kv_dtype):
    """The engine every serve path runs (prompts padded to 16s)."""
    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import InferenceEngine

    return InferenceEngine(params, cfg, specs, EngineConfig(
        max_seq_len=2048, prefill_chunk=16, kv_dtype=kv_dtype), device=dev)


class Replays:
    """Counts the device loop's captures and graph replays while it is
    entered (`with Replays() as r:`)."""

    def __enter__(self):
        from mixq_tpu_torch.engine.engine import DecodeLoop

        self.captures = self.replays = 0
        self._cls = DecodeLoop
        self._real = DecodeLoop.capture, DecodeLoop.replay
        capture, replay = self._real

        def counted_capture(loop):
            self.captures += 1
            return capture(loop)

        def counted_replay(loop, n=1):
            self.replays += n
            return replay(loop, n)

        DecodeLoop.capture, DecodeLoop.replay = counted_capture, counted_replay
        return self

    def __exit__(self, *exc):
        self._cls.capture, self._cls.replay = self._real
        return False


def stepwise_engine(eng):
    """The same engine (its parameters and head) with the device loop off:
    generate's stepwise host loop."""
    import copy
    import dataclasses

    other = copy.copy(eng)
    other.engine_cfg = dataclasses.replace(eng.engine_cfg,
                                           device_decode_loop=False)
    return other


def prime(eng):
    """One prefill of 16 tokens and one decode step of one row on a fresh
    cache of 128 slots: every kernel the engine's forward launches, in the
    layout generate's cache takes (a card_trace primer)."""
    cache = eng.new_cache(1, 128)
    tokens = torch.ones((1, 16), dtype=torch.int64, device=eng.device)
    _, cache = eng.prefill(tokens, cache)
    eng.decode_step(tokens[:, :1], cache)


def serve(dev, params, cfg, specs, name, kv_dtype, eng=None):
    """generate on `eng` (a new engine over `params` when None)."""
    from mixq_tpu_torch.kernels import (card_trace, launch_counts,
                                        reset_launch_counts)

    eng = eng or new_engine(dev, params, cfg, specs, kv_dtype)
    check(eng.engine_cfg.device_decode_loop, "the device loop is off")
    prompts = serve_prompts(cfg)
    lens = [len(p) for p in prompts]
    new = 32
    # the main path: generate under the profiler, which sees the kernels
    # the graph's replays run: one prefill + (new - 1) decode steps, on
    # generate's cache of round_up(48 + 32, 128) slots. CUPTI drops a few
    # kernel records from some windows and never adds any (on an H100: the
    # first kernel-1 and three kernel-2 runs of Baichuan-13B's generate; a
    # window with no device event at all): each window first runs a primer
    # (`prime`), which takes that loss and is left out of the counts; and
    # every generate runs the same kernels: a window short of some kernel
    # is run again, at most 6 windows, and each kernel's count is its most
    # in any window
    attn = attn_modes(cfg, specs, kv_dtype, 128)
    want = expect_launches(name, cfg, new, new - 1, attn)
    most, short = {}, []
    for _ in range(6):
        torch.cuda.synchronize()
        with Replays() as graph, card_trace(primer=lambda: prime(eng)) as prof:
            reset_launch_counts()
            out = eng.generate(prompts, max_new_tokens=new)
        counts = launch_counts()
        ran = ran_on_card(prof)
        most = {k: max(most.get(k, 0), v) for k, v in ran.items()}
        lost = {k: v - most[k] for k, v in want.items()
                if k in most and most[k] < v}
        if not lost:
            break
        short.append({k: v - ran[k] for k, v in want.items()
                      if k in ran and ran[k] < v})
    shape = (len(out), min(len(r) for r in out), max(len(r) for r in out))
    check(shape == (8, new, new), f"{name} generate returned shape {shape}")
    check(all(0 <= t < cfg.vocab_size for r in out for t in r),
          f"{name}: token out of range")
    # the decode steps ran as one eager step and new - 2 graph replays
    check((graph.captures, graph.replays) == (1, new - 2),
          f"{name}: {graph.captures} captures, {graph.replays} replays")
    # the wrappers launched the prefill, the eager step and the captured
    # step
    check_executed(most, want, f"{name} serve")
    check_launches(counts, expect_launches(name, cfg, 3, 2, attn),
                   f"{name} serve (wrapper launches)")
    # the same generate unprofiled, timed; then the stepwise host loop on
    # the same engine: the same tokens
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(again == out, f"{name}: two graph generates differ")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = stepwise_engine(eng).generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall_stepwise = time.perf_counter() - t0
    differ = [i for i, (a, b) in enumerate(zip(out, ref)) if a != b]
    check(not differ, f"{name}: graph generate rows {differ} differ from "
          "the stepwise generate's")
    return eng, dict(prompts=lens, new_tokens=new, tokens_shape=[8, new],
                     wall_s=wall, stepwise_wall_s=wall_stepwise,
                     graph_replays=graph.replays,
                     executed={k: v for k, v in most.items() if v},
                     short_windows=short,
                     launches={k: v for k, v in counts.items() if v},
                     tokens_equal_stepwise=True, first_row=out[0][:8],
                     distinct_rows=len({tuple(r) for r in out}),
                     constant_rows=sum(len(set(r)) == 1 for r in out))


def prefill_timing(dev, eng, cfg, B=8, T=64, n=3):
    """One prefill of B prompts x T tokens (M = B*T = 512 rows through
    every linear) into a fresh cache: device ms per prefill (CUPTI, over n
    after a warm-up) and wall ms per prefill (over n more). The tokens come
    from a generator of their own, so the later phases keep their
    inputs."""
    own = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(1, cfg.vocab_size, (B, T), generator=own,
                           device=dev)
    cache = eng.new_cache(B, 128)
    out = {}

    def run():
        cache.set_length(0)             # fresh: the prefill writes [0, T)
        out["logits"], _ = eng.prefill(tokens, cache)

    dev_ms = device_ms(run, n, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n
    logits = out.pop("logits")
    check(tuple(logits.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    return dict(batch=B, tokens=T, rows=B * T, device_ms=dev_ms,
                wall_ms=wall * 1e3)


def tensor_bytes(obj):
    """Bytes of every tensor in a parameter container (NamedTuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(tensor_bytes(x) for x in obj)
    return 0


def seed_cache(cache, gen):
    """Random cache contents (a step's cost does not depend on them): int8
    values and scales of 0.005-0.02, or N(0, 1) bf16 values."""
    for buf in (cache.k, cache.v):
        if cache.quantized:
            buf.random_(-127, 128, generator=gen)
        else:
            buf.normal_(generator=gen)
    if cache.quantized:
        for buf in (cache.k_scale, cache.v_scale):
            buf.uniform_(0.005, 0.02, generator=gen)


def decode_timing(dev, eng, cfg, gen, tag, name):
    """The decode step at B=64 with 512 filled positions (of 640 slots): the
    device loop's step (the forward, greedy sampling, the buffer writes),
    eagerly and as replays of its CUDA graph, each run from the same state
    (length 512, the same tokens). One eager step's launches by mode
    (asserted) and host syncs (none: set_sync_debug_mode("error")); 8
    eager steps against the capture and 8 replays, logits and tokens held
    bit-equal; the capture's host time; then 8 steps timed eager, graph,
    graph, eager (wall clock and CUDA events), and 8 of each under
    torch.profiler (the kernels the card ran, asserted; device ms,
    attention ms, busy share, top kernels)."""
    from mixq_tpu_torch.engine.engine import DecodeLoop
    from mixq_tpu_torch.engine.sampling import SamplingParams
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts

    B, fill, steps, warm, slots = 64, 512, 8, 2, 640
    cache = eng.new_cache(B, slots)
    seed_cache(cache, gen)
    kv_start = torch.zeros(B, dtype=torch.int32, device=dev)
    tok0 = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats()
    loop = DecodeLoop(eng, cache, kv_start, tok0, 1 + steps,
                      SamplingParams(), None)

    def rewind():
        cache.set_length(fill)
        loop.tok.copy_(tok0[:, None])
        loop.col.fill_(1)

    def eager(n):
        for _ in range(n):
            loop.step()

    rewind()
    eager(warm - 1)
    # the last warm-up step's launches: one decode step's, by mode; and no
    # host sync in it
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    per_step = {k: v for k, v in launch_counts().items() if v}
    kv_dtype = eng.engine_cfg.kv_dtype
    want = expect_launches(name, cfg, 1, 1,
                           attn_modes(cfg, eng.specs, kv_dtype, slots))
    check_launches(per_step, want, f"{tag} decode step")

    # the graph against the eager step, from the same state
    rewind()
    ref = [loop.step().clone() for _ in range(steps)]
    ref_tokens = loop.tokens.clone()
    rewind()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.capture()
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    got = []
    for _ in range(steps):
        loop.replay()
        got.append(loop.logits.clone())
    unequal = [i for i, (a, b) in enumerate(zip(ref, got))
               if not torch.equal(a, b)]
    diff = max((a - b).abs().max().item() for a, b in zip(ref, got))
    check(not unequal and torch.equal(ref_tokens, loop.tokens),
          f"{tag}: graph replay logits differ from the eager step's at "
          f"steps {unequal} (max |d| {diff})")
    logits = got[-1]
    check(tuple(logits.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode logits not finite")
    # the peak below is the step's, not that of the logits held above
    del ref, got, ref_tokens, logits
    torch.cuda.reset_peak_memory_stats()

    # in turns, each run from the same state
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    runs = {"eager": eager, "graph": loop.replay}
    timed = {"eager": [], "graph": []}
    for mode in ("eager", "graph", "graph", "eager"):
        rewind()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        runs[mode](steps)
        e1.record()
        torch.cuda.synchronize()
        timed[mode].append(((time.perf_counter() - t0) * 1e3 / steps,
                            e0.elapsed_time(e1) / steps))
    # least time of a step: every weight read once (of an untied embedding
    # only the B gathered rows), and the valid K/V rows (int8 with their f32
    # scales, or bf16) at the mean length of the timed steps
    p = eng.params
    kv_len = fill + (steps + 1) / 2
    unread = (0 if p.lm_head is None else tensor_bytes(p.embed)
              - B * cfg.hidden_size * p.embed.element_size())
    slot_bytes = (cfg.head_dim_ + 4 if kv_dtype == "int8"
                  else 2 * cfg.head_dim_)
    nbytes = (tensor_bytes(p) - unread + 2 * cfg.num_hidden_layers
              * cfg.num_key_value_heads * B * kv_len * slot_bytes)
    res = dict(batch=B, kv_filled=fill, steps=steps, kv_dtype=kv_dtype,
               head_major=cache.head_major, launches_per_step=per_step,
               bound_ms=bound_ms(nbytes, [])[0],
               graph_capture_ms=capture_ms,
               graph_logits_bit_equal_steps=steps)
    want_steps = {k: v * steps for k, v in want.items()}
    for mode in ("eager", "graph"):
        # CUPTI drops kernel records from some windows, mostly the first of
        # their block, and never adds any (on an H100: one of 512 kernel-1
        # runs; in one call the first three port kernels of every window
        # after some point; in two calls one of 512 kernel-1 and one or two
        # of 1,792 kernel-2 runs in each of six windows running): each
        # window first runs a primer, one step and the rewind, which takes
        # that loss and is left out of the counts and times; and every
        # window runs the same steps: a window short of some kernel is
        # profiled again after a 0.5 s pause, at most 6 windows, and each
        # kernel's count is its most in any window; the times are the
        # first complete window's
        most, short = {}, []
        for window in range(6):
            rewind()
            prof = profile_steps(runs[mode], f"{tag}_{mode}", steps,
                                 pause=0.5 if window else 0.05,
                                 primer=lambda: (runs[mode](1), rewind()))
            ran = prof.pop("ran")
            most = {k: max(most.get(k, 0), v) for k, v in ran.items()}
            lost = {k: v - ran[k] for k, v in want_steps.items()
                    if k in ran and ran[k] < v}
            if not lost:
                break
            short.append(lost)
        check_executed(most, want_steps, f"{tag} {mode} steps")
        prof.update(short_windows=short,
                    times_from_a_short_window=bool(lost))
        wall = [w for w, _ in timed[mode]]
        mean = sum(wall) / len(wall)
        res[mode] = dict(
            ms_per_step=wall,
            event_ms_per_step=[e for _, e in timed[mode]],
            tok_per_s=B / mean * 1e3, **prof)
    res["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
    return res


def profile_steps(run, tag, n, pause=0.05, primer=None):
    """Over `run(n)`, n decode steps under torch.profiler (device activity
    only; `card_trace(pause, primer)`), in the window's block (a primer's
    work left out): the port's kernels the card ran (`ran`, by launch-count
    key), the device time per step, the device's busy share (the device
    time over the wall time of the same block) and the top kernels; the
    profiler's table of the whole window goes to
    OUT_DIR/profile_<tag>.txt."""
    from mixq_tpu_torch.kernels import block_events, card_trace

    torch.cuda.synchronize()
    with card_trace(pause, primer) as prof:
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_us = _device_us(prof)
    # one stream: the kernels' durations cannot add up to more than the
    # block
    check(0 < dev_us <= wall_us, f"{tag}: device time {dev_us} us in a "
          f"block of {wall_us} us")
    by_name = {}
    for e in block_events(prof):
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + e.self_device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    attn_us = sum(us for name, (_, us) in by_name.items()
                  if "flash_decode_kernel" in name
                  or "decode_attention_kernel" in name)
    return dict(ran=ran_on_card(prof), profiled_steps=n,
                profiled_wall_ms_per_step=wall_us / n / 1e3,
                device_ms_per_step=dev_us / n / 1e3,
                attention_ms_per_step=attn_us / n / 1e3,
                device_busy_share=dev_us / wall_us,
                top_kernels_us_per_step=[
                    (name[:60], count, us / n)
                    for name, (count, us) in top])


def quik_step_split(dev, eng, cfg, gen, steps=2):
    """QUIK's decode step at B=64 with 512 filled positions (phase 6's
    state), 2 eager steps in a card_trace window with host activity (one
    run as its primer; host tracing of the step's ~3,900 ops is slow, so
    few steps): the device ms per step split into kernel A and
    kernel 2 in their zero-point modes, kernel 3, the asymmetric-quant
    glue (the device time under quik_linear's QUIK_QUANT ranges: outlier
    extract, inlier mask, quantizer) and the rest, and the busy share."""
    from mixq_tpu_torch.engine.engine import DecodeLoop
    from mixq_tpu_torch.engine.sampling import SamplingParams
    from mixq_tpu_torch.kernels import block_events, card_trace
    from mixq_tpu_torch.ops.mixed_linear import QUIK_QUANT

    B, fill = 64, 512
    cache = eng.new_cache(B, 640)
    seed_cache(cache, gen)
    kv_start = torch.zeros(B, dtype=torch.int32, device=dev)
    tok0 = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    loop = DecodeLoop(eng, cache, kv_start, tok0, 1 + steps,
                      SamplingParams(), None)

    def run():
        cache.set_length(fill)
        loop.tok.copy_(tok0[:, None])
        loop.col.fill_(1)
        for _ in range(steps):
            loop.step()

    run()
    torch.cuda.synchronize()
    with card_trace(primer=run, cpu=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the ranges' device-side annotations span their kernels: not counted
    kernels = [e for e in block_events(prof) if e.name != QUIK_QUANT]
    total = sum(e.self_device_time_total for e in kernels)

    def named(key):
        return sum(e.self_device_time_total for e in kernels
                   if key in e.name)

    def device_total(e):
        if hasattr(e, "device_time_total"):
            return e.device_time_total
        return e.cuda_time_total

    glue = sum(device_total(e)
               for e in block_events(prof, host_range=QUIK_QUANT))
    parts = {"kernel_A_w4_zp": named("mix_gemm_zp_kernel<true>"),
             "kernel_2_w8a8_zp": named("mix_gemm_zp_kernel<false>"),
             "kernel_3": named("flash_decode_kernel"),
             "asymmetric_quant_glue": glue}
    out = {k + "_ms_per_step": v / steps / 1e3 for k, v in parts.items()}
    out.update(device_ms_per_step=total / steps / 1e3,
               rest_ms_per_step=(total - sum(parts.values())) / steps / 1e3,
               busy_share=total / 1e6 / wall, steps=steps,
               ran=ran_on_card(prof))
    check(all(v > 0 for v in parts.values()),
          f"QUIK step split: a part took no device time: {parts}")
    with open(os.path.join(OUT_DIR, "profile_QUIK_W4A4_split.txt"),
              "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    return out


def ring_step(dev, eng, cfg, gen):
    """One decode step at batch 16 on a window-sized ring (4096 slots)
    filled past its wrap (length 4096 + 37), every kernel-8 launch held
    against its plain version on its own inputs (Tap)."""
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.kernels.decode_attention import DECODE_ATOL

    B, S = 16, cfg.sliding_window
    cache = eng.new_cache(B, S)
    check(not cache.head_major and cache.max_seq == S,
          "Mistral's window-sized cache is not a batch-major ring")
    seed_cache(cache, gen)
    cache.set_length(S + 37)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    kv_start = torch.zeros(B, dtype=torch.int32, device=dev)
    reset_launch_counts()
    with Tap() as tap:
        logits, _ = eng.decode_step(tok, cache, kv_start)
        torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    launches = [r for r in tap.kernel if r["kernel"] == "decode_attention"]
    L = cfg.num_hidden_layers
    check(counts.get("decode_attention.ring") == L and len(launches) == L,
          f"ring step: launches {counts}")
    worst = max(r["beyond"] for r in launches)
    check(worst <= DECODE_ATOL and bool(torch.isfinite(logits).all()),
          f"ring step: a decode_attention launch is {worst} beyond two ulps "
          "of its plain version")
    return dict(batch=B, slots=S, length=S + 37, launches=counts,
                worst_launch_beyond_2_ulps=worst, tolerance=DECODE_ATOL)


# the served paths, one after another: (model, configuration, label,
# profile tag, KV type, attn_impl). The Llama and Gemma paths of PRs 1-3
# stay on the head-major cache (kernel 3): Llama's int8 KV does under
# "auto", Gemma's by "flash"; Mistral and Llama with bf16 KV take the
# batch-major cache (kernel 8) under "auto".
PATHS = [
    ("Llama-2-7B", "W8A8", "Llama-2-7B W8A8O16", "W8A8O16", "int8", "auto"),
    ("Llama-2-7B", "W4A4", "Llama-2-7B W4A4O16", "W4A4O16", "int8", "auto"),
    ("Llama-2-7B", "W4A4 grouped", "Llama-2-7B W4A4O16 group_size=128",
     "W4A4O16_g128", "int8", "auto"),
    ("Llama-2-7B", "W8A16", "Llama-2-7B W8A16", "W8A16", "int8", "auto"),
    ("Gemma-2-9B", "W8A8", "Gemma-2-9B W8A8O16", "gemma2_W8A8O16", "int8",
     "flash"),
    ("Gemma-2-9B", "W4A4", "Gemma-2-9B W4A4O16", "gemma2_W4A4O16", "int8",
     "flash"),
    ("Gemma-2-9B", "W8A16", "Gemma-2-9B W8A16", "gemma2_W8A16", "int8",
     "flash"),
    ("Mistral-7B", "W8A8", "Mistral-7B W8A8O16", "mistral_W8A8O16", "int8",
     "auto"),
    ("Llama-2-7B", "W8A8", "Llama-2-7B W8A8O16 bf16 KV", "W8A8O16_bf16kv",
     "bfloat16", "auto"),
    ("Llama-2-7B", "QUIK", "Llama-2-7B QUIK W4A4", "QUIK_W4A4", "int8",
     "auto"),
]
# random outlier channels of every linear input at init: MIX's 128, QUIK's
# 256 (QuantConfig.quik_w4a4)
INIT_BUDGET = {"QUIK": 256}
# phase 6 times the decode step and the prefill of these paths only (a cut
# for the time limit): the random-init Llama-2-7B W8A8O16 step, which phase
# 7 sets beside the warmed one, Mistral-7B's, the ring through kernel 8, and
# QUIK's, with its step split into kernels and glue (quik_step_split).
# The others' rows in PERF.md section 5 are earlier runs'; every path is
# still served (phase 5).
TIMED_PATHS = ("Llama-2-7B W8A8O16", "Mistral-7B W8A8O16",
               "Llama-2-7B QUIK W4A4")
# depth cut for the time limit (with QUIK's phases): phase 5 serves
# Gemma-2-9B's three paths at 21 of its 42 layers (full width; the
# alternating windows, softcaps and every kernel mode unchanged)
SERVE_LAYERS = {"Gemma-2-9B": 21}
MODELS = {"Llama-2-7B": llama2_7b, "Gemma-2-9B": gemma2_9b,
          "Mistral-7B": mistral_7b}

# phase 8 runs Baichuan-13B at 20 of its 40 layers, full width (a depth
# cut for the time limit)
BAICHUAN_LAYERS = 20
# Phase 8's two serve paths: (label, profile tag, attn_impl, KV type)
BAICHUAN_PATHS = [
    ("Baichuan-13B W8A8O16 bf16 KV (auto)", "baichuan_auto_bf16kv", "auto",
     "bfloat16"),
    ("Baichuan-13B W8A8O16 int8 KV (flash)", "baichuan_flash_int8kv",
     "flash", "int8")]

# phase 11's pools (SPEC_POOLS): bf16 KV batch-major, int8 KV head-major
SPEC_LABELS = (
    "Llama-2-7B W8A8O16 Markov spec bf16 KV (auto, batch-major)",
    "Llama-2-7B W8A8O16 Markov spec int8 KV (flash, head-major)")
# the kernels line: one entry per ported TPU kernel (a row of PERF.md's
# table) and per mode a later slice added to a path: (name, source module,
# REPLACES attribute, phase-3 row key, launch-count keys, the serve runs
# whose counts are summed: None for all of them, phase 10 among them);
# the module's SOURCE. An entry's launches are the kernels the card ran in
# those runs, read by name (ran_on_card; phase 10: in its profiled
# windows); wrapper_launches are the wrappers' counts (the prefill, the
# eager step, the captured step; phase 10: all of its launches)
KERNEL_ROWS = [
    ("rmsnorm_quant", "rmsnorm_quant", "REPLACES", "rmsnorm_quant",
     ("rmsnorm_quant",), None),
    ("mix_gemm_w8a8", "mix_gemm", "REPLACES", "mix_gemm",
     ("mix_gemm.w8a8",), None),
    ("mix_gemm_w4_grouped", "mix_gemm", "REPLACES_W4", "mix_gemm_w4_grouped",
     ("mix_gemm.w4", "mix_gemm.w4_grouped", "mix_gemm.w8a8_grouped"), None),
    ("mix_gemm_a16", "w8a16", "REPLACES", "mix_gemm_a16", ("w8a16",),
     None),
    ("w8a16_matmul", "w8a16", "REPLACES_W8A16", "w8a16_matmul",
     ("w8a16.w8",), None),
    ("int8_matmul_dequant", "mix_gemm", "REPLACES_INT8_MATMUL",
     "int8_matmul_dequant", ("mix_gemm.w8a8",), None),
    ("flash_decode", "flash_decode", "REPLACES", "flash_decode",
     ("flash_decode",), None),
    ("mix_gemm_w8a8_gelu_new", "mix_gemm", "REPLACES", "gelu_w8a8",
     ("mix_gemm.gelu_new",), ("Gemma-2-9B W8A8O16",)),
    ("mix_gemm_w4_gelu_new", "mix_gemm", "REPLACES_W4", "gelu_w4",
     ("mix_gemm.gelu_new",), ("Gemma-2-9B W4A4O16",)),
    ("mix_gemm_a16_gelu_new", "w8a16", "REPLACES", "gelu_a16",
     ("w8a16.gelu_new",), ("Gemma-2-9B W8A16",)),
    ("flash_decode_softcap", "flash_decode", "REPLACES",
     "flash_decode_softcap", ("flash_decode.softcap",), None),
    ("decode_attention", "decode_attention", "REPLACES", "decode_attention",
     ("decode_attention",), None),
    ("flash_decode_alibi", "flash_decode", "REPLACES", "flash_decode_alibi",
     ("flash_decode.alibi",), (BAICHUAN_PATHS[1][0],)),
    ("decode_attention_alibi", "decode_attention", "REPLACES",
     "decode_attention_alibi", ("decode_attention.alibi",),
     (BAICHUAN_PATHS[0][0],)),
    ("flash_decode_pool", "flash_decode", "REPLACES", "flash_decode_pool",
     ("flash_decode",), ("Llama-2-7B W8A8O16 CB int8 KV (flash, "
                         "head-major)",)),
    ("decode_attention_pool", "decode_attention", "REPLACES",
     "decode_attention_pool", ("decode_attention",),
     ("Llama-2-7B W8A8O16 CB bf16 KV (auto, batch-major)",)),
    ("rmsnorm_quant_verify", "rmsnorm_quant", "REPLACES",
     "rmsnorm_quant_verify", ("rmsnorm_quant",), SPEC_LABELS),
    ("mix_gemm_w8a8_verify", "mix_gemm", "REPLACES", "mix_gemm_verify",
     ("mix_gemm.w8a8",), SPEC_LABELS),
    ("flash_decode_verify", "flash_decode", "REPLACES",
     "flash_decode_verify", ("flash_decode",), SPEC_LABELS[1:]),
    ("mix_gemm_w8a8_zp", "mix_gemm", "REPLACES_QUIK", "quik_w8a8",
     ("mix_gemm.w8a8_zp",), None),
    ("mix_gemm_w4_zp", "mix_gemm", "REPLACES_QUIK", "quik_w4",
     ("mix_gemm.w4_zp",), None),
]
# entries whose mode is a runtime argument (the gelu_new epilogue), which
# a kernel's name does not show: the card's runs are counted by the
# instantiation that serves it
EXECUTED_AS = {"mix_gemm_w8a8_gelu_new": ("mix_gemm.w8a8",),
               "mix_gemm_w4_gelu_new": ("mix_gemm.w4",),
               "mix_gemm_a16_gelu_new": ("w8a16.w8",),
               "flash_decode_alibi": ("flash_decode",),
               "decode_attention_alibi": ("decode_attention",)}
KERNEL_NOTES = {
    "mix_gemm_w8a8_zp": "kernel 2 (W8) in QUIK's zero-point mode "
                        "(mix_gemm_zp_kernel<false>: o/down of QUIK W4A4, "
                        "A8 asymmetric); timed row: o and down of one "
                        "Llama-2-7B block at M=64, 256 outlier channels; "
                        "replaces JAX's jnp int8 dot_general and zero-point "
                        "epilogue in quik_linear (no Pallas kernel)",
    "mix_gemm_w4_zp": "kernel A (packed W4) in QUIK's zero-point mode "
                      "(mix_gemm_zp_kernel<true>: q/k/v/up/gate of QUIK "
                      "W4A4, A4 asymmetric); timed row: the five W4 "
                      "linears of one Llama-2-7B block at M=64, 256 "
                      "outlier channels; replaces JAX's jnp int8 "
                      "dot_general and zero-point epilogue in quik_linear "
                      "(no Pallas kernel)",
    "flash_decode_pool": "kernel 3 at phase 9's int8 head-major pool: 64 "
                         "slots of 640 positions, rows of length 1 to 640 "
                         "in one launch; launches: the card's runs in that "
                         "pool's profiled window (R = 8 decode steps)",
    "rmsnorm_quant_verify": "kernel 1 at phase 11's verify rows (64 slots "
                            "x spec_k 4 = 256, H=4096, A8); launches: the "
                            "card's runs in phase 11's profiled windows (a "
                            "spec window of 8 verify rounds and a plain "
                            "window of 8 steps, each pool)",
    "mix_gemm_w8a8_verify": "kernel 2 (W8A8) at phase 11's verify rows "
                            "(M=256); timed row: up, 4096 x 11008 (every "
                            "block shape is held and timed in phase 3); "
                            "launches: the card's runs in phase 11's "
                            "profiled windows",
    "flash_decode_verify": "kernel 3 at the speculative verify's per-row "
                           "lengths (phase 11's int8 head-major pool: 64 "
                           "slots of 640, the last of 4 verify tokens at "
                           "slot_lengths + 4); one launch per verify token "
                           "(Queue B item 1); launches: the card's runs in "
                           "that pool's profiled windows (8 verify rounds "
                           "x 4 x 16 layers, and a plain window's 8 x 16)",
    "decode_attention_pool": "kernel 8 at phase 9's bf16 batch-major pool "
                             "(JAX's default engine configuration): 64 "
                             "slots of 640 positions, rows of length 1 to "
                             "640 in one launch; launches: the card's runs "
                             "in that pool's profiled window (R = 8 decode "
                             "steps)",
    "w8a16_matmul": "launches: the a16 kernel's int8 per-channel mode, "
                    "which computes this entry's function",
    "int8_matmul_dequant": "launches: kernel 2's W8A8 mode, which computes "
                           "this entry's function",
    "mix_gemm_w8a8_gelu_new": "kernel 2 (W8A8) with the gelu_new epilogue, "
                              "Gemma-2-9B's gate; launches: the Gemma-2-9B "
                              "W8A8O16 run's kernel-2 W8A8 runs (the "
                              "epilogue is not in the kernel's name), "
                              "wrapper_launches its gelu_new launches",
    "mix_gemm_w4_gelu_new": "kernel A (packed W4) with the gelu_new "
                            "epilogue, Gemma-2-9B's gate; launches: the "
                            "Gemma-2-9B W4A4O16 run's kernel-A runs (the "
                            "epilogue is not in the kernel's name), "
                            "wrapper_launches its gelu_new launches",
    "mix_gemm_a16_gelu_new": "kernel B (W8A16) with the gelu_new epilogue, "
                             "Gemma-2-9B's gate; launches: the Gemma-2-9B "
                             "W8A16 run's kernel-B W8 runs (the epilogue is "
                             "not in the kernel's name), wrapper_launches "
                             "its gelu_new launches",
    "flash_decode_softcap": "kernel 3 in gemma2's logit-softcap mode; "
                            "launches: the Gemma-2-9B runs'",
    "decode_attention": "kernel 8 over the batch-major cache; timed row: "
                        "Llama-2-7B bf16 KV (the one with a library call); "
                        "launches: the Mistral-7B (int8, ring), Llama-2-7B "
                        "bf16-KV and Baichuan-13B \"auto\" runs'",
    "flash_decode_alibi": "kernel 3 in its ALiBi mode (the Pallas kernel's "
                          "has_alibi branch, mixq_tpu/ops/pallas/"
                          "flash_decode.py:340-348); timed row: Baichuan-13B "
                          "int8 KV; launches: the Baichuan-13B run under "
                          "\"flash\" (the slopes are a runtime argument, "
                          "not in the kernel's name), wrapper_launches its "
                          "ALiBi launches",
    "decode_attention_alibi": "kernel 8 in its ALiBi mode (attend's bias, "
                              "mixq_tpu/models/layers.py:824-830); timed "
                              "row: Baichuan-13B bf16 KV (with SDPA and the "
                              "bias as a float mask beside it); launches: "
                              "the Baichuan-13B run under \"auto\", "
                              "wrapper_launches its ALiBi launches",
}


# ---------------------------------------------------------------------------
# Phase 7: from float weights to served tokens
# ---------------------------------------------------------------------------

# Embedding channels boosted into outliers, their boost, and the spread of
# the embedding's rows. The rows are N(0, EMBED_STD), as torch.nn.Embedding
# makes them, so that each token's own channels still steer every layer
# beside the planted ones (at N(0, 0.02) and a boost of 1000 the tokens'
# channels fell below bf16's rounding and every served row was one
# repeated token). BOOST is the least of 200, 250, 300 and 400 that keeps
# the planted channels' normed maxima past 2 sigma in all 32 layers (200
# gave 1.98; phase7_scan.py); the margin is asserted and reported.
PLANTED, BOOST, EMBED_STD, SIGMA = (11, 1003, 2050, 3071), 250.0, 1.0, 6.0
# one prefill's logits of the warmed W8A8 model against the FP16-spec model
# of the same float weights: their distance over the reference's spread
# over positions (`logits_gap`) under this limit, and under a quarter of the
# distance of the same model with its promoted rows dropped (the fault of a
# promotion that zeroes a row of the int weight and never fills the outlier
# term), so that the check would see that fault, and under half of the
# quantized model's before warmup (phase7_scan.py reads all three at each
# boost)
LOGITS_REL_TOL = 0.5


def float_state_dict(cfg, dev, seed=7, layers=None, boost=BOOST):
    """A bf16 state dict of `cfg` under HF's llama names (baichuan: q, k
    and v as one W_pack tensor, rows [q | k | v]) on the card from `seed`:
    N(0, EMBED_STD) embedding rows with the PLANTED channels raised by
    `boost`, N(0, 0.02) linear weights and head, norms of ones. `layers`
    keeps only the first blocks (phase7_scan.py sets the boost)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)

    def w(*shape, std=0.02):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16) * std

    def ones():
        return torch.ones(H, device=dev, dtype=torch.bfloat16)

    sd = {"model.embed_tokens.weight": w(V, H, std=EMBED_STD),
          "model.norm.weight": ones(), "lm_head.weight": w(V, H)}
    sd["model.embed_tokens.weight"][:, list(PLANTED)] += boost
    qkv = ((("self_attn.W_pack", ((nq + 2 * nkv) * hd, H)),)
           if cfg.model_type == "baichuan" else
           (("self_attn.q_proj", (nq * hd, H)),
            ("self_attn.k_proj", (nkv * hd, H)),
            ("self_attn.v_proj", (nkv * hd, H))))
    for i in range(cfg.num_hidden_layers if layers is None else layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = ones()
        sd[p + "post_attention_layernorm.weight"] = ones()
        for name, shape in qkv + (("self_attn.o_proj", (H, nq * hd)),
                            ("mlp.gate_proj", (I, H)),
                            ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))):
            sd[p + name + ".weight"] = w(*shape)
    torch.cuda.synchronize()
    return sd


def token_batches(cfg, n, B, T, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, cfg.vocab_size, (B, T), generator=g)
            for _ in range(n)]


def prefill_logits(params, cfg, specs, tokens, head_f32=None):
    """The f32 logits [B, T, V] of one prefill of `tokens` (on the card)
    into a fresh batch-major bf16 cache."""
    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.layers import KVCache

    B, T = tokens.shape
    cache = KVCache.create(cfg.num_hidden_layers, B, T,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           torch.bfloat16, head_major=False,
                           device=tokens.device)
    if head_f32 is None:
        head_f32 = lm_head_f32(params, specs)
    with torch.inference_mode():
        return forward(params, tokens, cache, specs, cfg,
                       head_f32=head_f32)[0]


def logits_gap(logits, ref):
    """||logits - ref|| over the reference's spread over positions,
    ||ref - its mean over positions|| (the planted channels give every
    position a common part, which a relative error would hide behind),
    and the share of positions whose top token is the reference's."""
    spread = (ref - ref.mean(dim=(0, 1))).norm()
    return dict(rel=((logits - ref).norm() / spread).item(),
                top1_agree=(logits.argmax(-1) == ref.argmax(-1))
                .float().mean().item())


def drop_promoted_rows(params):
    """`params` with every linear's promoted rows zeroed: the int rows
    zeroed by the promotion, the outlier term empty."""
    def drop(lin):
        if lin is None or lin.w_outlier is None:
            return lin
        return lin._replace(w_outlier=torch.zeros_like(lin.w_outlier))

    return params._replace(blocks=tuple(
        bp._replace(attn=bp.attn._replace(**{
            n: drop(getattr(bp.attn, n)) for n in ("wq", "wk", "wv", "wo")}),
            mlp=bp.mlp._replace(**{
                n: drop(getattr(bp.mlp, n)) for n in ("up", "gate", "down")}))
        for bp in params.blocks))


def linear_sets(params):
    """{"{layer}.{slot}": the live channels of the slot's set, in slot
    order} from the first linear of each slot."""
    out = {}
    for i, bp in enumerate(params.blocks):
        for slot, lin in (("wqkv", bp.attn.wq), ("wo", bp.attn.wo),
                          ("up", bp.mlp.up), ("down", bp.mlp.down)):
            out[f"{i}.{slot}"] = lin.out_ind[:int(lin.out_count)].tolist()
    return out


def plain_sets(stats_log, budget, sigma=SIGMA):
    """The online rule, plainly, from each warmup step's stats (on the
    host): after each step, the channels past sigma not yet in the set,
    largest first, ties by the lower index, appended up to the budget."""
    import numpy as np

    sets = {k: [] for k in stats_log[0]}
    for stats in stats_log:
        for k, m in stats.items():
            m = m.float().cpu().numpy()
            have = set(sets[k])
            new = [int(c) for c in np.argsort(-m, kind="stable")
                   if m[c] > sigma and int(c) not in have]
            sets[k] += new[:budget - len(sets[k])]
    return sets


def planted_margins(stats_log, layers):
    """For each warmup step, the planted channels' lowest normed maximum
    over the wqkv and up slots of every layer, in sigmas, and its slot."""
    out = []
    for stats in stats_log:
        low = min((stats[f"{i}.{s}"][list(PLANTED)].min().item() / SIGMA,
                   f"{i}.{s}") for i in range(layers) for s in ("wqkv", "up"))
        out.append(dict(sigmas=low[0], slot=low[1]))
    return out


def tensors_of(obj):
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for x in obj for t in tensors_of(x)]


def bit_equal_to_cpu(card, cpu):
    """Whether every tensor of two parameter trees has the same dtype,
    shape and bits (the card's copied to the host); and their count."""
    a, b = tensors_of(card), tensors_of(cpu)
    same = len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y) for x, y in zip(a, b))
    return same, len(b)


def slot_linears(params, key):
    """The linears that read stats slot `key` ("{layer}.{slot}")."""
    from mixq_tpu_torch.quantize.online import SLOT_LINEARS

    i, slot = key.split(".")
    part, names = next((p, ns) for s, p, ns in SLOT_LINEARS if s == slot)
    return [getattr(getattr(params.blocks[int(i)], part), n) for n in names]


def cpu_check(dev, sd, cfg, qcfg):
    """The first 2 layers at full width: the card's quantize_model
    bit-equal to the CPU's of the same float weights, then warmup_online
    on both (2 batches of 2 x 64 tokens): the sets and counts equal on
    every slot whose stats are bit-equal or whose channel maxima lie
    farther from sigma than the two devices' stats differ (asserted for
    every wqkv and up slot; a channel within that spread of sigma may
    join on one device only). The promoted params are bit-equal: the
    whole tree when every slot was compared, else the compared slots'
    linears."""
    import dataclasses

    from mixq_tpu_torch.models.hf import TensorSource
    from mixq_tpu_torch.quantize import quantize_model, warmup_online_outliers

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    keep = [k for k in sd if not k.startswith("model.layers.")
            or int(k.split(".")[2]) < 2]
    sd_card = {k: sd[k] for k in keep}
    sd_cpu = {k: sd[k].cpu() for k in keep}
    t0 = time.perf_counter()
    card, specs = quantize_model(TensorSource.from_torch_state_dict(sd_card),
                                 cfg2, qcfg, device=dev)
    cpu, _ = quantize_model(TensorSource.from_torch_state_dict(sd_cpu), cfg2,
                            qcfg, device="cpu")
    same, n = bit_equal_to_cpu(card, cpu)
    check(same, "the card's quantize_model of 2 layers differs from the "
          "CPU's")
    batches = token_batches(cfg, 2, 2, 64, seed=21)
    logs = {"card": [], "cpu": []}
    card, c_card = warmup_online_outliers(card, cfg2, specs, batches,
                                          stats_log=logs["card"])
    cpu, c_cpu = warmup_online_outliers(cpu, cfg2, specs, batches,
                                        stats_log=logs["cpu"])
    s_card, s_cpu = linear_sets(card), linear_sets(cpu)
    compared, res = [], {}
    for k in s_cpu:
        spread = max((a[k].cpu() - b[k]).abs().max().item()
                     for a, b in zip(logs["card"], logs["cpu"]))
        margin = min((b[k] - SIGMA).abs().min().item() for b in logs["cpu"])
        res[k] = dict(spread=spread, margin_to_sigma=margin)
        # equal stats give equal sets; else no channel may lie within the
        # stats' difference of sigma
        if spread == 0 or margin > spread:
            check(s_card[k] == s_cpu[k] and c_card[k] == c_cpu[k],
                  f"2-layer {k}: card set {s_card[k]} (count {c_card[k]}) "
                  f"!= CPU set {s_cpu[k]} (count {c_cpu[k]})")
            compared.append(k)
    check(all(f"{i}.{s}" in compared for i in range(2)
              for s in ("wqkv", "up")),
          f"2-layer warmup: a wqkv/up slot lies within the card-vs-CPU "
          f"spread of sigma: {res}")
    # equal sets promote equal rows of bit-equal weights
    if len(compared) == len(s_cpu):
        same_w, n_w = bit_equal_to_cpu(card, cpu)
    else:
        same_w, n_w = bit_equal_to_cpu(
            [slot_linears(card, k) for k in compared],
            [slot_linears(cpu, k) for k in compared])
    check(same_w, f"2-layer promoted params differ on the card and the CPU "
          f"(slots {compared})")
    return dict(layers=2, tensors_bit_equal=n, counts_card=c_card,
                counts_cpu=c_cpu,
                sets_compared=compared, promoted_tensors_bit_equal=n_w,
                by_slot=res, seconds=time.perf_counter() - t0)


# phase 7's disk: the HF directory (13.48 GB) and the W8A8O16 checkpoint
# (about 7.35 GB) lie on it at once
DISK_NEED = 22e9
# the HF directory's shard size: transformers' default max_shard_size, 5GB
HF_SHARD_BYTES = 5 * 10 ** 9


def disk_room(path):
    """The free space where phase 7 writes, printed; the run fails with
    the numbers below DISK_NEED."""
    free = shutil.disk_usage(path).free
    print(f"pipeline: checkpoints under {path}, {free / 1e9:.2f} GB free "
          f"(needs {DISK_NEED / 1e9:.0f} GB)", flush=True)
    check(free >= DISK_NEED, f"{path} has {free / 1e9:.2f} GB free; phase "
          f"7 writes up to {DISK_NEED / 1e9:.0f} GB at once")
    return dict(path=path, free_gb=free / 1e9, need_gb=DISK_NEED / 1e9)


def hf_config_json(cfg):
    """config.json of Llama-2-7B's published fields (presets.llama2_7b)."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "hidden_act": "silu", "tie_word_embeddings": False,
            "torch_dtype": "bfloat16"}


def write_hf_dir(path, sd, cfg):
    """`sd` (on the card) as an HF directory: shards of at most
    HF_SHARD_BYTES through the port's save_file, its
    model.safetensors.index.json and config.json. Host seconds, bytes and
    GB/s of the write (into the page cache; nothing is synced)."""
    from mixq_tpu_torch.utils.safetensors_io import save_file

    os.makedirs(path)
    shards, sizes = [{}], [0]
    for k, t in sd.items():
        n = t.numel() * t.element_size()
        if sizes[-1] + n > HF_SHARD_BYTES and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][k] = t
        sizes[-1] += n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    weight_map, written = {}, 0
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        written += save_file(shard, os.path.join(path, name),
                             metadata={"format": "pt"})
        weight_map.update(dict.fromkeys(shard, name))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes)},
                   "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_json(cfg), f, indent=2)
    secs = time.perf_counter() - t0
    return dict(bytes=written, seconds=secs, gb_per_s=written / secs / 1e9,
                shards=sorted(set(weight_map.values())),
                index="model.safetensors.index.json")


def timed_read(fn, nbytes, peaks):
    """fn() (a load onto the card), its host seconds and GB/s over
    `nbytes`, and the card's peak memory while it ran (`peaks` keeps the
    peak from before, since the peak is reset here). The files were just
    written: the read is warm, from the page cache."""
    torch.cuda.synchronize()
    peaks.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return out, dict(bytes=nbytes, seconds=secs,
                     gb_per_s=nbytes / secs / 1e9, warm=True,
                     peak_gib=peak / 2 ** 30,
                     peak_added_gib=(peak - base) / 2 ** 30)


def bit_equal(a, b):
    """Whether two parameter trees on the card have the same dtypes,
    shapes and bytes; and their tensor count."""
    xs, ys = tensors_of(a), tensors_of(b)
    same = len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.reshape(-1).view(torch.uint8),
                        y.reshape(-1).view(torch.uint8))
        for x, y in zip(xs, ys))
    return same, len(xs)


def round_trip(dev, path, params, cfg, qcfg, specs, peaks):
    """save_checkpoint of `params`, then AutoModel.from_quantized onto the
    card: every tensor bit-equal, the same config and specs. Returns the
    loaded params and the write and read."""
    from mixq_tpu_torch.models.auto import AutoModel
    from mixq_tpu_torch.quantize import save_checkpoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbytes = save_checkpoint(path, params, cfg, qcfg)
    secs = time.perf_counter() - t0
    (loaded, cfg2, specs2), read = timed_read(
        lambda: AutoModel.from_quantized(path, device=dev), nbytes, peaks)
    same, n = bit_equal(loaded, params)
    check(same and cfg2 == cfg and specs2 == specs,
          f"{path}: the loaded checkpoint differs from the saved params "
          f"(bit-equal {same}, config {cfg2 == cfg}, specs {specs2 == specs})")
    return loaded, dict(write=dict(bytes=nbytes, seconds=secs,
                                   gb_per_s=nbytes / secs / 1e9),
                        read=read, tensors_bit_equal=n,
                        files=sorted(os.listdir(path)))


def serve_prompts(cfg, lens=(5, 9, 13, 17, 21, 26, 30, 37), seed=2):
    """serve()'s prompts."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
            for n in lens]


def generate_cli(dev, path, params, cfg, specs):
    """generate_torch.py on the checkpoint at `path`, in a subprocess on
    the card, against the in-process generate of the same params (its
    EngineConfig: max_seq_len 2048, bf16 KV): the same greedy tokens."""
    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import InferenceEngine

    prompts, new = serve_prompts(cfg, lens=(7, 19, 33), seed=5), 16
    eng = InferenceEngine(params, cfg, specs, EngineConfig(
        max_seq_len=2048, kv_dtype="bfloat16"), device=dev)
    ref = eng.generate(prompts, max_new_tokens=new)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(here, "generate_torch.py"),
         "--model_path", path, "--device", str(dev), "--max_new_tokens",
         str(new), "--prompt_ids",
         *[",".join(map(str, p)) for p in prompts]],
        capture_output=True, text=True, timeout=600, cwd=here)
    secs = time.perf_counter() - t0
    check(r.returncode == 0, f"generate_torch.py exited {r.returncode}: "
          f"{r.stderr[-3000:]}")
    got = [json.loads(x)["token_ids"] for x in r.stdout.strip().splitlines()]
    check(got == ref, f"generate_torch.py's tokens {got} differ from the "
          f"in-process generate's {ref}")
    return dict(prompts=[len(p) for p in prompts], new_tokens=new,
                host_s=secs, tokens_equal=True, first_row=ref[0])


def pipeline_phase(dev, gen, report):
    """Phase 7 (pipeline_run) in a directory of its own under the temp
    directory, deleted when the phase ends, failed or not."""
    root = tempfile.mkdtemp(prefix="mixq_ckpt_")
    try:
        return pipeline_run(dev, gen, report, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def pipeline_run(dev, gen, report, root):
    """Phase 7: Llama-2-7B at full width and depth from a float state dict
    on the card, written as an HF safetensors directory and read back
    through AutoModel.from_pretrained (bit-equal to quantize_model of the
    dict in memory), through warmup_online and generate, held against the
    FP16-spec model of the same weights; the warmed W8A8O16 params and the
    W4A4O16 params through save_checkpoint and from_quantized (bit-equal),
    generate_torch.py on the W8A8O16 checkpoint. Returns (its report, the
    W8A8O16 params loaded from the checkpoint and their specs, which phase
    9 serves)."""
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.models.auto import AutoModel
    from mixq_tpu_torch.models.decoder import DecoderSpecs
    from mixq_tpu_torch.models.hf import (TensorSource, load_hf_config,
                                          params_from_source)
    from mixq_tpu_torch.quantize import (collect_act_scales,
                                         outlier_sets_from_scales,
                                         quantize_model)

    cfg = llama2_7b()
    out, secs, peaks = {}, {}, []
    torch.cuda.reset_peak_memory_stats()
    out["disk"] = disk_room(root)

    # W8A8: empty sets, then the online predictor
    t0 = time.perf_counter()
    sd = float_state_dict(cfg, dev)
    secs["float_dict_w8a8"] = time.perf_counter() - t0
    # the float dict on disk as an HF directory, read back below
    hf_dir = os.path.join(root, "hf")
    io = out["checkpoints"] = {"hf_write": write_hf_dir(hf_dir, sd, cfg)}
    check(load_hf_config(hf_dir) == cfg, "config.json does not give "
          "Llama-2-7B's config")
    hf_bytes = io["hf_write"]["bytes"]
    print(f"pipeline: HF directory written: {io['hf_write']}", flush=True)
    src = TensorSource.from_torch_state_dict(sd)
    qcfg = QuantConfig.w8a8()
    t0 = time.perf_counter()
    params, specs = quantize_model(src, cfg, qcfg, device=dev)
    torch.cuda.synchronize()
    secs["quantize_model_w8a8"] = time.perf_counter() - t0
    (disk, cfg_d, specs_d), io["hf_read_w8a8"] = timed_read(
        lambda: AutoModel.from_pretrained(hf_dir, qcfg, device=dev),
        hf_bytes, peaks)
    same, n = bit_equal(disk, params)
    check(same and cfg_d == cfg and specs_d == specs, "AutoModel."
          "from_pretrained of the HF directory differs from quantize_model "
          "of the dict in memory")
    io["hf_read_w8a8"].update(tensors_bit_equal=n,
                              shards=io["hf_write"]["shards"],
                              index=io["hf_write"]["index"])
    print(f"pipeline: W8A8 from the HF directory, bit-equal: "
          f"{io['hf_read_w8a8']}", flush=True)
    del disk
    out["cpu_check"] = cpu_check(dev, sd, cfg, qcfg)
    print(f"pipeline: 2 layers card vs CPU {out['cpu_check']}", flush=True)
    # the reference: the FP16-spec model of the same float weights, one
    # prefill of 8 x 64 tokens; then calibration alone on it (the W4A4
    # quantize_model below runs the same on a copy of its own)
    fp_specs = DecoderSpecs.fp16()
    fp_params = params_from_source(src, cfg, fp_specs, device=dev)
    tokens = token_batches(cfg, 1, 8, 64, seed=24)[0].to(dev, torch.int32)
    ref = prefill_logits(fp_params, cfg, fp_specs, tokens)
    unpromoted = logits_gap(prefill_logits(params, cfg, specs, tokens), ref)
    calib = token_batches(cfg, 2, 8, 64, seed=23)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = collect_act_scales(fp_params, cfg, calib)
    torch.cuda.synchronize()
    secs["calibration"] = time.perf_counter() - t0
    del sd, src, fp_params
    gc.collect()
    torch.cuda.empty_cache()
    eng = new_engine(dev, params, cfg, specs, "int8")
    del params
    batches = token_batches(cfg, 2, 8, 64, seed=22)
    log = []
    t0 = time.perf_counter()
    counts = eng.warmup_online(batches, stats_log=log)
    torch.cuda.synchronize()
    secs["warmup_online"] = time.perf_counter() - t0
    budget = qcfg.outlier_budget
    check(all(0 <= n <= budget for n in counts.values()),
          f"warmup counts past the budget {budget}: {counts}")
    sets = linear_sets(eng.params)
    check(sets == plain_sets(log, budget), "warmup sets differ from the "
          "plain rule on the card's own stats")
    missing = {k: sorted(set(PLANTED) - set(v)) for k, v in sets.items()
               if k.endswith((".wqkv", ".up")) and set(PLANTED) - set(v)}
    check(not missing, f"planted channels missing from sets: {missing}")
    margins = planted_margins(log, cfg.num_hidden_layers)
    low = min(m["sigmas"] for m in margins)
    check(low > 2, f"planted channels clear {low:.2f} sigma, not 2: "
          f"{margins}")
    warmed = logits_gap(prefill_logits(eng.params, cfg, specs, tokens,
                                       eng.head_f32), ref)
    dropped = logits_gap(prefill_logits(drop_promoted_rows(eng.params), cfg,
                                        specs, tokens, eng.head_f32), ref)
    out["w8a8"] = dict(
        counts_by_slot={s: [counts[f"{i}.{s}"]
                            for i in range(cfg.num_hidden_layers)]
                        for s in ("wqkv", "wo", "up", "down")},
        planted=list(PLANTED), boost=BOOST, embed_std=EMBED_STD,
        planted_margin_by_step=margins, sets_equal_plain_rule=True,
        warmup_batches=[8, 64],
        logits_vs_fp16_spec=dict(warmed=warmed, before_warmup=unpromoted,
                                 promoted_rows_dropped=dropped,
                                 tokens=[8, 64]))
    print(f"pipeline W8A8 warmup: {out['w8a8']}", flush=True)
    check(warmed["rel"] < LOGITS_REL_TOL
          and warmed["rel"] < dropped["rel"] / 4
          and warmed["rel"] < unpromoted["rel"] / 2,
          f"the warmed W8A8 model's logits lie {warmed['rel']:.4g} from the "
          f"FP16-spec model's (limit {LOGITS_REL_TOL}; with the promoted "
          f"rows dropped {dropped['rel']:.4g}, before warmup "
          f"{unpromoted['rel']:.4g})")
    eng, out["w8a8"]["serve"] = serve(dev, None, cfg, specs, "W8A8", "int8",
                                      eng=eng)
    print(f"pipeline W8A8 serve: {out['w8a8']['serve']}", flush=True)
    varied(out["w8a8"]["serve"], "W8A8")
    dec = decode_timing(dev, eng, cfg, gen, "pipeline_W8A8O16", "W8A8")
    ref_step = report["paths"]["Llama-2-7B W8A8O16"]["decode"]["graph"]
    out["w8a8"]["decode"] = dict(
        graph_device_ms_per_step=dec["graph"]["device_ms_per_step"],
        eager_device_ms_per_step=dec["eager"]["device_ms_per_step"],
        random_init_graph_device_ms_per_step=ref_step["device_ms_per_step"],
        ratio_to_random_init=(dec["graph"]["device_ms_per_step"]
                              / ref_step["device_ms_per_step"]),
        graph_ms_per_step=dec["graph"]["ms_per_step"],
        max_memory_allocated_gib=dec["max_memory_allocated_gib"])
    print(f"pipeline W8A8 decode: {out['w8a8']['decode']}", flush=True)
    warmed, warmed_specs = eng.params, eng.specs
    del eng, dec
    gc.collect()
    torch.cuda.empty_cache()
    # the warmed params through a checkpoint: phase 9 serves the loaded
    # ones; generate_torch.py serves the checkpoint in a process of its own
    ck8 = os.path.join(root, "w8a8o16")
    served, io["w8a8o16"] = round_trip(dev, ck8, warmed, cfg, qcfg,
                                       warmed_specs, peaks)
    del warmed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"pipeline: W8A8O16 checkpoint round trip, bit-equal: "
          f"{io['w8a8o16']}", flush=True)
    io["w8a8o16"]["generate_cli"] = generate_cli(dev, ck8, served, cfg,
                                                 warmed_specs)
    print(f"pipeline: generate_torch.py on the checkpoint: "
          f"{io['w8a8o16']['generate_cli']}", flush=True)
    shutil.rmtree(ck8)

    # W4A4: calibration on the card, then the calibrated sets; a second
    # read of the HF directory (each tensor twice: the FP16 copy that
    # calibrates, then the quantized weights)
    w4 = QuantConfig.w4a4()
    (params, _, specs), io["hf_read_w4a4"] = timed_read(
        lambda: AutoModel.from_pretrained(hf_dir, w4, calib_batches=calib,
                                          device=dev), 2 * hf_bytes, peaks)
    # QUIK W4A4 from the same directory, calibrating on the card (served
    # after the W4A4 model, quik_pipeline)
    quik = QuantConfig.quik_w4a4()
    (qparams, _, qspecs), io["hf_read_quik"] = timed_read(
        lambda: AutoModel.from_pretrained(hf_dir, quik, calib_batches=calib,
                                          device=dev), 2 * hf_bytes, peaks)
    shutil.rmtree(hf_dir)
    gc.collect()
    torch.cuda.empty_cache()
    sets = linear_sets(params)
    check(all(len(v) == 128 for v in sets.values()),
          "calibrated W4A4 sets are not full")
    alone = {k: s.ind[:int(s.count)].tolist() for k, s in
             outlier_sets_from_scales(scales, w4, device=dev).items()}
    check(sets == alone, "the W4A4 sets differ from the top channels of "
          "the calibration run alone")
    missing = {k: sorted(set(PLANTED) - set(v)) for k, v in sets.items()
               if k.endswith((".wqkv", ".up")) and set(PLANTED) - set(v)}
    check(not missing, f"W4A4: planted channels not calibrated: {missing}")
    eng, serve_w4 = serve(dev, params, cfg, specs, "W4A4", "int8")
    out["w4a4"] = dict(serve=serve_w4, calib_batches=[2, 8, 64],
                       logits_vs_fp16_spec=logits_gap(prefill_logits(
                           eng.params, cfg, specs, tokens, eng.head_f32),
                           ref))
    print(f"pipeline W4A4: {out['w4a4']}", flush=True)
    varied(serve_w4, "W4A4")
    # the W4A4 params through a checkpoint serve the in-memory model's
    # greedy tokens, through kernel A
    prompts = serve_prompts(cfg)
    want = eng.generate(prompts, max_new_tokens=32)
    del eng, ref
    gc.collect()
    torch.cuda.empty_cache()
    ck4 = os.path.join(root, "w4a4o16")
    loaded, io["w4a4o16"] = round_trip(dev, ck4, params, cfg, w4, specs,
                                       peaks)
    shutil.rmtree(ck4)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng = new_engine(dev, loaded, cfg, specs, "int8")
    reset_launch_counts()
    got = eng.generate(prompts, max_new_tokens=32)
    counts = launch_counts()
    check(got == want, "the W4A4O16 checkpoint serves other greedy tokens "
          "than the params it was saved from")
    check(counts["mix_gemm.w4"] > 0, f"the loaded W4A4O16 model ran no "
          f"kernel A launch: {counts}")
    io["w4a4o16"].update(tokens_equal=True, launches={
        k: v for k, v in counts.items() if v})
    print(f"pipeline: W4A4O16 checkpoint round trip: {io['w4a4o16']}",
          flush=True)
    del eng, loaded
    gc.collect()
    torch.cuda.empty_cache()
    out["quik"] = quik_pipeline(dev, root, qparams, cfg, quik, qspecs,
                                scales, io, peaks)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    out["host_s"] = secs
    out["max_memory_allocated_gib"] = max(
        peaks + [torch.cuda.max_memory_allocated()]) / 2 ** 30
    print(f"pipeline host seconds: {secs}; peak memory "
          f"{out['max_memory_allocated_gib']:.2f} GiB", flush=True)
    return out, served, warmed_specs


def quik_pipeline(dev, root, params, cfg, qcfg, specs, scales, io, peaks):
    """Phase 7's QUIK W4A4 model (AutoModel.from_pretrained with
    calibration on the card): its sets (256 a linear input) equal the top
    channels of the calibration run alone; served by generate (8 prompts,
    32 greedy tokens: kernels 2 and A in their zero-point modes, no kernel
    1; phase 5 profiles the same path); its checkpoint through
    save_checkpoint and from_quantized, bit-equal, and the loaded params
    serve the in-memory model's greedy tokens."""
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.quantize import outlier_sets_from_scales

    sets = linear_sets(params)
    budget = qcfg.outlier_budget
    check(all(len(v) == budget for v in sets.values()),
          f"calibrated QUIK sets are not full ({budget})")
    alone = {k: s.ind[:int(s.count)].tolist() for k, s in
             outlier_sets_from_scales(scales, qcfg, device=dev).items()}
    check(sets == alone, "the QUIK sets differ from the top channels of "
          "the calibration run alone")
    check(all(lin.reduced_w is not None for bp in params.blocks
              for lin in (bp.attn.wq, bp.attn.wo, bp.mlp.gate, bp.mlp.down)),
          "a QUIK linear without reduced_w")
    eng = new_engine(dev, params, cfg, specs, "int8")
    prompts = serve_prompts(cfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    want = eng.generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    check(counts.get("mix_gemm.w4_zp", 0) > 0
          and counts.get("mix_gemm.w8a8_zp", 0) > 0
          and "rmsnorm_quant" not in counts,
          f"the calibrated QUIK model's launches: {counts}")
    out = dict(budget=budget, generate_wall_s=wall, launches=counts,
               distinct_rows=len({tuple(r) for r in want}),
               constant_rows=sum(len(set(r)) == 1 for r in want),
               first_row=want[0][:8])
    print(f"pipeline QUIK: {out}", flush=True)
    varied(out, "QUIK")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ck = os.path.join(root, "quik_w4a4")
    loaded, io["quik_w4a4"] = round_trip(dev, ck, params, cfg, qcfg, specs,
                                         peaks)
    shutil.rmtree(ck)
    eng = new_engine(dev, loaded, cfg, specs, "int8")
    reset_launch_counts()
    got = eng.generate(prompts, max_new_tokens=32)
    counts = launch_counts()
    check(got == want, "the QUIK checkpoint serves other greedy tokens than "
          "the params it was saved from")
    check(counts["mix_gemm.w4_zp"] > 0 and counts["mix_gemm.w8a8_zp"] > 0
          and counts["rmsnorm_quant"] == 0,
          f"the loaded QUIK model's launches: {counts}")
    io["quik_w4a4"].update(tokens_equal=True, launches={
        k: v for k, v in counts.items() if v})
    print(f"pipeline: QUIK W4A4 checkpoint round trip: {io['quik_w4a4']}",
          flush=True)
    del eng, loaded
    return out


def baichuan_phase(dev, gen):
    """Phase 8: Baichuan-13B at full width and depth from a W_pack state
    dict on the card through quantize_model (W8A8, empty sets) and
    warmup_online, served under "auto" (batch-major bf16 KV: kernel 8 with
    ALiBi) and under "flash" (head-major int8 KV: kernel 3 with ALiBi)."""
    import dataclasses

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.hf import TensorSource
    from mixq_tpu_torch.quantize import quantize_model

    cfg = baichuan_13b()
    check(cfg.alibi and cfg.rope_style == "none",
          "Baichuan-13B's config does not take ALiBi")
    cfg = dataclasses.replace(cfg, num_hidden_layers=BAICHUAN_LAYERS)
    out, secs = {}, {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = float_state_dict(cfg, dev)
    secs["float_dict"] = time.perf_counter() - t0
    check("model.layers.0.self_attn.W_pack.weight" in sd
          and "model.layers.0.self_attn.q_proj.weight" not in sd,
          "the state dict is not under Baichuan's names")
    qcfg = QuantConfig.w8a8()
    t0 = time.perf_counter()
    params, specs = quantize_model(TensorSource.from_torch_state_dict(sd),
                                   cfg, qcfg, device=dev)
    torch.cuda.synchronize()
    secs["quantize_model"] = time.perf_counter() - t0
    out["param_gib"] = tensor_bytes(params) / 2 ** 30
    out["cpu_check"] = cpu_check(dev, sd, cfg, qcfg)
    print(f"baichuan: 2 layers card vs CPU {out['cpu_check']}", flush=True)
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    label, tag, attn_impl, kv_dtype = BAICHUAN_PATHS[0]
    eng = new_engine(dev, params, cfg, dataclasses.replace(
        specs, attn_impl=attn_impl), kv_dtype)
    del params
    batches = token_batches(cfg, 2, 8, 64, seed=22)
    log = []
    t0 = time.perf_counter()
    counts = eng.warmup_online(batches, stats_log=log)
    torch.cuda.synchronize()
    secs["warmup_online"] = time.perf_counter() - t0
    budget = qcfg.outlier_budget
    check(all(0 <= n <= budget for n in counts.values()),
          f"warmup counts past the budget {budget}: {counts}")
    check(linear_sets(eng.params) == plain_sets(log, budget),
          "warmup sets differ from the plain rule on the card's own stats")
    out["counts_by_slot"] = {s: [counts[f"{i}.{s}"]
                                 for i in range(cfg.num_hidden_layers)]
                             for s in ("wqkv", "wo", "up", "down")}
    out["planted_margin_by_step"] = planted_margins(log,
                                                    cfg.num_hidden_layers)
    out["host_s"] = secs
    print(f"baichuan: host seconds {secs}; counts by slot "
          f"{out['counts_by_slot']}; planted margins "
          f"{out['planted_margin_by_step']}", flush=True)
    out["paths"] = {}
    for label, tag, attn_impl, kv_dtype in BAICHUAN_PATHS:
        if eng is None:           # the warmed params under the next policy
            eng = new_engine(dev, params, cfg, dataclasses.replace(
                specs, attn_impl=attn_impl), kv_dtype)
        path = {"attn_impl": attn_impl, "kv_dtype": kv_dtype}
        eng, path["serve"] = serve(dev, None, cfg, eng.specs, "W8A8",
                                   kv_dtype, eng=eng)
        print(f"serve {label}: {path['serve']}", flush=True)
        # the step timed under "auto" only (kernel 8 with ALiBi; a cut for
        # the time limit: kernel 3 with ALiBi is timed in phase 3)
        if attn_impl == "auto":
            path["decode"] = decode_timing(dev, eng, cfg, gen, tag, "W8A8")
            decode = {k: ({m: x for m, x in v.items()
                           if m != "top_kernels_us_per_step"}
                          if isinstance(v, dict)
                          and k != "launches_per_step" else v)
                      for k, v in path["decode"].items()}
            print(f"decode {label}: {decode}", flush=True)
        out["paths"][label] = path
        params = eng.params
        del eng
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
    print(f"baichuan: peak memory {out['max_memory_allocated_gib']:.2f} GiB",
          flush=True)
    return out


def varied(served, name):
    """The served rows are neither all one row nor all one repeated token
    each (the tokens' own channels reach the head)."""
    check(served["distinct_rows"] > 1 and served["constant_rows"] < 8,
          f"{name}: {served['distinct_rows']} distinct rows of 8, "
          f"{served['constant_rows']} of one repeated token")


# ---------------------------------------------------------------------------
# Phase 9: continuous batching
# ---------------------------------------------------------------------------

# the pools, one after another: (label, attn_impl, KV type). JAX's default
# engine configuration first (bf16 KV under "auto": the batch-major pool,
# kernel 8), then the int8 head-major pool (kernel 3)
CB_POOLS = [("Llama-2-7B W8A8O16 CB bf16 KV (auto, batch-major)", "auto",
             "bfloat16"),
            ("Llama-2-7B W8A8O16 CB int8 KV (flash, head-major)", "flash",
             "int8")]
CB_SLOTS, CB_SEQ = 64, 640
# the traffic script (benchserve.py's rule, :160-200): requests with prompts
# uniform over 16-256 tokens and budgets over 16-128 new tokens arrive at
# window boundaries, at most CB_BURST a window (each of CB_BURST arrives
# with probability 1/2); CB_SAMPLED sample, CB_STOPPED carry a stop set
CB_REQUESTS, CB_BURST = 192, 16
CB_PROMPT, CB_NEW = (16, 256), (16, 128)
CB_SAMPLED, CB_STOPPED = 8, 4
CB_SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.9)
# one prefill bucket for every prompt of the script (at most 256 tokens):
# an admission group's prefill is [k_pad, 256] whatever its prompts
CB_PREFILL_CHUNK = 256
# windows profiled one by one (each a card_trace of its R steps alone),
# until one shows every kernel run the steps imply
CB_PROFILED = (6, 7, 8, 9, 10, 11)


def cb_script(cfg, seed=0):
    """The requests (prompt, budget, sampling or None) and the arrivals of
    each window, from `seed`."""
    import random

    from mixq_tpu_torch.engine import SamplingParams

    rng = random.Random(seed)
    reqs = [dict(prompt=[rng.randrange(1, cfg.vocab_size)
                         for _ in range(rng.randint(*CB_PROMPT))],
                 budget=rng.randint(*CB_NEW), sampling=None, stop=None)
            for _ in range(CB_REQUESTS)]
    for i in rng.sample(range(CB_REQUESTS), CB_SAMPLED):
        reqs[i]["sampling"] = SamplingParams(**CB_SAMPLING)
    greedy = [i for i, r in enumerate(reqs) if r["sampling"] is None]
    stopped = sorted(rng.sample(greedy, CB_STOPPED))
    arrivals, left = [], CB_REQUESTS
    while left:
        n = min(left, sum(rng.random() < 0.5 for _ in range(CB_BURST)))
        arrivals.append(n)
        left -= n
    return reqs, arrivals, stopped


class Forwards:
    """Counts the CB engine's forward calls (prefill chunks, and T=1 steps
    run eagerly or captured) while it is entered, and the most rows
    (k_pad x chunk) a prefill chunk ran."""

    def __enter__(self):
        from mixq_tpu_torch.engine import batching

        self.prefill = self.step = self.prefill_m = 0
        self._mod, self._real = batching, batching.forward

        def counted(params, tokens, *a, **kw):
            if tokens.shape[1] > 1:
                self.prefill += 1
                self.prefill_m = max(self.prefill_m, tokens.numel())
            else:
                self.step += 1
            return self._real(params, tokens, *a, **kw)

        batching.forward = counted
        return self

    def __exit__(self, *exc):
        self._mod.forward = self._real
        return False


def cb_run(eng, reqs, arrivals, windowed, profile=None):
    """Serve the script: the requests of window w arrive before window w
    (windowed) or before step w * R (single steps, `step`). Returns the
    records by request index and, per window, (wall ms, tokens taken,
    profiled); `profile(window)` may wrap a window's decode run."""
    R = eng._window_r
    rid_of, records, windows = {}, {}, []
    nxt, w, step = 0, 0, 0
    while nxt < len(reqs) or eng.has_work:
        if windowed or step % R == 0:
            for _ in range(arrivals[w] if w < len(arrivals) else 0):
                r = reqs[nxt]
                rid_of[eng.add_request(
                    r["prompt"], r["budget"], sampling=r["sampling"],
                    stop_token_ids=r["stop"])] = nxt
                nxt += 1
            w += 1
        if windowed:
            before = sum(len(o) for o in eng._outputs.values())
            done = sum(len(v["tokens"]) for v in records.values())
            real = eng._run_window
            profiled = profile is not None and profile.wants(w - 1)
            if profiled:
                eng._run_window = profile.wrap(w - 1, real)
            t0 = time.perf_counter()
            eng.step_window()
            ms = (time.perf_counter() - t0) * 1e3
            eng._run_window = real
        else:
            eng.step()
        for rid, rec in eng.finished_records().items():
            records[rid_of[rid]] = rec
        if windowed:
            taken = (sum(len(o) for o in eng._outputs.values())
                     + sum(len(v["tokens"]) for v in records.values())
                     - before - done)
            windows.append((ms, taken, profiled))
        step += 1
        check(step < 100000, "the CB script did not drain")
    return records, windows, step


class WindowProfile:
    """Profiles the decode runs of the windows in CB_PROFILED one by one
    (a card_trace around the R steps), until one shows every kernel run
    that R steps imply. The trace's primer is an eager greedy step from the
    window's own state, which is then put back: it writes the KV position
    the window's first step writes, with the same values."""

    def __init__(self, eng, want, tag):
        self.eng, self.want, self.tag = eng, want, tag
        self.done, self.most, self.short, self.first = False, {}, [], None
        self.primed = 0

    def wants(self, w):
        return not self.done and w in CB_PROFILED

    def wrap(self, w, real):
        def primer():
            self.primed += 1
            with torch.inference_mode():
                state = self.eng._state.clone()
                self.eng._col.zero_()
                self.eng._step(False)
                self.eng._state.copy_(state)

        def run():
            prof = profile_steps(lambda n: real(), f"{self.tag}_window{w}",
                                 self.eng._window_r, primer=primer)
            ran = prof.pop("ran")
            self.most = {k: max(self.most.get(k, 0), v)
                         for k, v in ran.items()}
            lost = {k: v - ran[k] for k, v in self.want.items()
                    if k in ran and ran[k] < v}
            if self.first is None or not lost:
                self.first = dict(window=w, **prof)
            if lost:
                self.short.append(lost)
            else:
                self.done = True
        return run


def cb_phase(dev, params, cfg, specs):
    """Phase 9: Llama-2-7B W8A8O16 (phase 7's warmed params) served by the
    continuous-batching engine on a pool of 64 slots x 640 positions, under
    "auto" with bf16 KV (batch-major, kernel 8) and "flash" with int8 KV
    (head-major, kernel 3): the 192-request script through step_window
    (CUDA graph replays), then the same script through single eager steps
    on the same engine; greedy tokens equal, every request ends at its
    budget or its stop token, the slot-mode forward bit-equal to the
    scalar one at equal lengths, the native scheduler in use."""
    reqs, arrivals, stopped = cb_script(cfg)
    out = {"script": dict(
        requests=CB_REQUESTS, arrivals_per_window=arrivals,
        burst=CB_BURST, prompt_tokens=sum(len(r["prompt"]) for r in reqs),
        budget_tokens=sum(r["budget"] for r in reqs),
        sampled=[i for i, r in enumerate(reqs) if r["sampling"]],
        stopped=stopped, sampling=CB_SAMPLING,
        prefill_chunk=CB_PREFILL_CHUNK), "pools": {}}
    for label, attn_impl, kv_dtype in CB_POOLS:
        out["pools"][label] = cb_pool(dev, params, cfg, specs, label,
                                      attn_impl, kv_dtype, reqs, arrivals,
                                      stopped)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def cb_pool(dev, params, cfg, specs, label, attn_impl, kv_dtype, reqs,
            arrivals, stopped):
    """Phase 9 on one pool (cb_phase); the engine and its pool are freed
    when it returns."""
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
    from mixq_tpu_torch.engine.scheduler import NativeScheduler
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.models.decoder import forward

    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(
        params, cfg, dataclasses.replace(specs, attn_impl=attn_impl),
        EngineConfig(max_batch_size=CB_SLOTS, max_seq_len=CB_SEQ,
                     prefill_chunk=CB_PREFILL_CHUNK, kv_dtype=kv_dtype),
        device=dev)
    check(isinstance(eng.sched, NativeScheduler),
          f"{label}: the scheduler is {type(eng.sched).__name__}")
    check(eng.cache.head_major == (kv_dtype == "int8"),
          f"{label}: the pool's layout")
    R = eng._window_r
    pool = {"attn_impl": attn_impl, "kv_dtype": kv_dtype,
            "slots": CB_SLOTS, "positions": CB_SEQ, "window_r": R,
            "head_major": eng.cache.head_major,
            "scheduler": type(eng.sched).__name__,
            "pool_gib": tensor_bytes((eng.cache.k, eng.cache.v,
                                      eng.cache.k_scale,
                                      eng.cache.v_scale)) / 2 ** 30}
    # the stop tokens: the 4th greedy token of each stopped request's
    # prompt served alone on this pool (its first window captures the
    # greedy graph)
    timings = {"capture_ms": [], "admit_ms": []}
    real_capture, real_admit = eng._capture, eng._admit_many

    def timed(store, fn):
        def call(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            timings[store].append((time.perf_counter() - t0) * 1e3)
            return r
        return call

    eng._capture = timed("capture_ms", real_capture)
    probe = [eng.add_request(reqs[i]["prompt"], 4) for i in stopped]
    got = eng.run_to_completion()
    for i, rid in zip(stopped, probe):
        reqs[i]["stop"] = [got[rid][3]]
    pool["stop_tokens"] = [reqs[i]["stop"][0] for i in stopped]
    # the main path: the script through windows, counts set to 0 first
    attn = attn_modes(cfg, eng.specs, kv_dtype, CB_SEQ)
    eng._admit_many = timed("admit_ms", real_admit)
    profile = WindowProfile(eng, expect_launches("W8A8", cfg, R, R,
                                                 attn),
                            f"cb_{kv_dtype}")
    graphs = set(eng._graphs)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Forwards() as fw:
        recs, windows, _ = cb_run(eng, reqs, arrivals, True, profile)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in launch_counts().items() if v}
    eng._admit_many = real_admit
    check(profile.done, f"{label}: every profiled window lost kernel "
          f"records: {profile.short}")
    check_executed(profile.most, profile.want, f"{label} window")
    # phase 3 held kernels 1 and 2 at every admission prefill's rows
    check(fw.prefill_m <= CB_PREFILL_M, f"{label}: an admission prefill ran "
          f"{fw.prefill_m} rows, past the {CB_PREFILL_M} at which phase 3 "
          "held kernels 1 and 2")
    # the wrappers: every eager forward (prefill chunks, the first step
    # of a mode, the profiled windows' primers) and the captured step
    # (once a mode: the greedy one in the stop-token probe, the sampling
    # one in the script)
    check_launches(counts, expect_launches(
        "W8A8", cfg, fw.prefill + fw.step, fw.step, attn),
        f"{label} (wrapper launches)")
    new = set(eng._graphs) - graphs
    check(sorted(eng._graphs) == [False, True]
          and fw.step == 2 * len(new) + profile.primed,
          f"{label}: {fw.step} eager steps, graphs {sorted(graphs)} "
          f"before the script and {sorted(eng._graphs)} after")
    # every request ends at its budget or at its stop token
    check(sorted(recs) == list(range(CB_REQUESTS)),
          f"{label}: {len(recs)} of {CB_REQUESTS} requests finished")
    stops = 0
    for i, r in enumerate(reqs):
        toks = recs[i]["tokens"]
        stop = bool(r["stop"]) and toks[-1] in r["stop"]
        stops += stop
        check(len(toks) == r["budget"] or (stop and len(toks)
                                           <= r["budget"]),
              f"{label}: request {i} ended after {len(toks)} of "
              f"{r['budget']} tokens")
        check(all(0 <= t < cfg.vocab_size for t in toks)
              and len(recs[i]["logprobs"]) == len(toks)
              and all(x <= 0 for x in recs[i]["logprobs"]),
              f"{label}: request {i}'s tokens or logprobs")
    free = [(ms, n) for ms, n, prof in windows if not prof]
    ms_sorted = sorted(ms for ms, _ in free)
    tokens = sum(len(v["tokens"]) for v in recs.values())
    pool.update(
        requests=len(recs), tokens=tokens, windows=len(windows),
        stopped_at_stop_token=stops, wall_s=wall,
        unprofiled_windows=len(free),
        unprofiled_wall_s=sum(ms for ms, _ in free) / 1e3,
        tok_per_s=sum(n for _, n in free) / sum(ms for ms, _ in free)
        * 1e3,
        ms_per_window_median=ms_sorted[len(ms_sorted) // 2],
        ms_per_window_p90=ms_sorted[int(0.9 * (len(ms_sorted) - 1))],
        admissions=len(timings["admit_ms"]),
        admission_ms_total=sum(timings["admit_ms"]),
        admission_ms_median=sorted(timings["admit_ms"])[
            len(timings["admit_ms"]) // 2],
        capture_ms=timings["capture_ms"],
        prefill_forwards=fw.prefill, prefill_rows_most=fw.prefill_m,
        eager_steps=fw.step,
        window_profile=profile.first,
        profile_short_windows=profile.short,
        launches=counts, executed=profile.most,
        executed_want_per_window=profile.want)
    pool["serve"] = {"executed": profile.most, "launches": counts}
    print(f"cb {label}: {CB_REQUESTS} requests, {tokens} tokens, "
          f"{len(windows)} windows, {wall:.2f} s wall "
          f"({pool['unprofiled_wall_s']:.2f} s over the "
          f"{len(free)} unprofiled windows: {pool['tok_per_s']:.1f} "
          f"tok/s); ms per window median "
          f"{pool['ms_per_window_median']:.2f}, p90 "
          f"{pool['ms_per_window_p90']:.2f}; {len(timings['admit_ms'])}"
          f" admissions, {pool['admission_ms_total']:.1f} ms in all "
          f"(median {pool['admission_ms_median']:.2f}); capture ms "
          f"{timings['capture_ms']}; {stops} of {CB_STOPPED} stopped "
          "at their stop token", flush=True)
    wp = {k: v for k, v in profile.first.items()
          if k != "top_kernels_us_per_step"}
    print(f"cb {label} window {wp['window']}: device ms per step "
          f"{wp['device_ms_per_step']:.3f} (attention "
          f"{wp['attention_ms_per_step']:.3f}), busy "
          f"{wp['device_busy_share']:.3f}, by kernel (name, runs, us per "
          f"step) {profile.first['top_kernels_us_per_step']}; the card "
          f"ran {profile.most} of {profile.want} a window", flush=True)

    # the same script through single eager steps, on the same engine
    t0 = time.perf_counter()
    steps_recs, _, n_steps = cb_run(eng, reqs, arrivals, False)
    pool["stepwise_wall_s"] = time.perf_counter() - t0
    pool["stepwise_steps"] = n_steps
    greedy = [i for i, r in enumerate(reqs) if r["sampling"] is None]
    differ = [i for i in greedy
              if steps_recs[i]["tokens"] != recs[i]["tokens"]]
    check(not differ, f"{label}: greedy requests {differ} differ "
          "between windows and single steps")
    pool["greedy_equal_stepwise"] = len(greedy)

    # every row at one length: the slot-mode step bit-equal to the
    # scalar-length step on the same batch and cache
    L0 = 300
    tok = torch.randint(1, cfg.vocab_size, (CB_SLOTS, 1), device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(9))
    with torch.inference_mode():
        slot, _ = forward(eng.params, tok, eng.cache, eng.specs, cfg,
                          head_f32=eng.head_f32,
                          slot_lengths=torch.full(
                              (CB_SLOTS,), L0, dtype=torch.int32,
                              device=dev))
        eng.cache.set_length(L0)
        scalar, _ = forward(eng.params, tok, eng.cache, eng.specs, cfg,
                            head_f32=eng.head_f32)
        eng.cache.set_length(0)
    check(torch.equal(slot, scalar) and bool(torch.isfinite(slot).all()),
          f"{label}: slot-mode logits differ from the scalar forward's "
          f"(max |d| {(slot - scalar).abs().max().item()})")
    pool["slot_logits_bit_equal_scalar"] = True
    pool["verify_vs_steps"] = verify_vs_steps(eng, cfg, label)
    pool["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 30)
    print(f"cb {label}: {len(greedy)} greedy requests equal through "
          f"{n_steps} single steps ({pool['stepwise_wall_s']:.1f} s); "
          f"slot-mode logits bit-equal to the scalar forward's; peak "
          f"memory {pool['max_memory_allocated_gib']:.2f} GiB (pool "
          f"{pool['pool_gib']:.2f} GiB)", flush=True)
    return pool


# the verify held against T=1 steps (verify_vs_steps). Layer 0's attention
# output within one bf16 ulp of |steps'| + VERIFY_ABS of their max: its
# inputs are bit-equal either way (kernels 1 and 2 are bit-equal across
# their plans, phase 3); on the head-major pool kernel 3 makes the same
# calls (row b's query t at length slot_lengths[b] + t + 1), on the
# batch-major pool the steps run kernel 8's plain version (`attend` at
# T=1, the verify's arithmetic: f32 products of other shapes, an ulp at
# most). The logits through every layer: on the head-major pool within
# VERIFY_ABS of their max (the same kernels on the same inputs, the f32
# head aside); on the batch-major pool, whose steps run kernel 8, by their
# argmaxes clear of near-ties: an ulp flips an int8 activation, which moves a
# W8A8 model's logits by ~1e-2 of their max at each layer (phase 9's
# random Llama-2-7B on the bf16 pool: 0.017 through 1 layer, 0.16
# through 32)
VERIFY_ABS = 1e-5


def verify_vs_steps(eng, cfg, label, control=True, seed=9):
    """One full-pool verify forward (SPEC_K tokens a row at ragged lengths
    of 16-380, teacher-forced) on the engine's live cache against SPEC_K
    T=1 slot steps of the same tokens on the same cache: through layer 0,
    the verify's attention output within one bf16 ulp (plus VERIFY_ABS of
    the max) of the steps' (batch-major: kernel 8's plain version);
    through every layer, finite logits whose argmax equals the main
    path's steps' (kernel 3 or 8) wherever their top-2 margin clears twice
    that row's gap, and on the head-major pool within VERIFY_ABS of their
    max. The control (asserted with `control`): the same limit rejects
    layer 0's attention of the verify one position late (what a span
    written or rotated at the wrong position gives), run first. Returns
    the record."""
    import mixq_tpu_torch.models.decoder as D
    from mixq_tpu_torch.kernels.decode_attention import (
        decode_attention_plain)

    dev, B, k = eng.device, eng.n_slots, SPEC_K
    hm = eng.cache.head_major
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(16, 384 - k, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (B, k), generator=g, device=dev)
    layer0 = eng.params._replace(blocks=eng.params.blocks[:1])

    def fwd(params, t, at):
        return D.forward(params, t, eng.cache, eng.specs, cfg,
                         head_f32=eng.head_f32, slot_lengths=at)[0]

    def steps(params):
        return [fwd(params, toks[:, t:t + 1], lens + t) for t in range(k)]

    def attention(name, fn, run):
        """The outputs of D.<name> (run as `fn`, or itself) while run()."""
        real, got = getattr(D, name), []

        def spy(*a, **kw):
            got.append((fn or real)(*a, **kw))
            return got[-1]

        setattr(D, name, spy)
        try:
            run()
        finally:
            setattr(D, name, real)
        return got

    step_attn = (("flash_decode_attention", None) if hm
                 else ("decode_attention", decode_attention_plain))
    # each forward writes the span it reads (the late one's last position
    # is read by no later forward)
    with torch.inference_mode():
        late = attention("_verify_attend", None,
                         lambda: fwd(layer0, toks, lens + 1))[0]
        ref = torch.stack(attention(*step_attn, lambda: steps(layer0)), 1)
        ver = attention("_verify_attend", None,
                        lambda: fwd(layer0, toks, lens))[0]
        main = torch.cat(steps(eng.params), 1)
        full = fwd(eng.params, toks, lens)
    ref, ver, late = ref.float(), ver.float(), late.float()
    peak = ref.abs().max()
    limit = BF16_ULP * ref.abs() + VERIFY_ABS * peak
    diff = (ver - ref).abs()
    gap = (diff.max() / peak).item()
    late_gap = ((late - ref).abs().max() / peak).item()
    within = bool((diff <= limit).all())
    late_beyond = ((late - ref).abs() > limit).float().mean().item()
    gaps = (full - main).abs().amax(-1)                          # [B, k]
    logits_gap = (gaps.max() / main.abs().max()).item()
    top2 = torch.topk(main, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * gaps
    same = torch.argmax(full, -1) == torch.argmax(main, -1)
    check(within and bool(torch.isfinite(full).all())
          and bool(same[clear].all())
          and (not hm or logits_gap <= VERIFY_ABS),
          f"{label}: layer 0's verify attention "
          f"{'within' if within else 'beyond'} one bf16 ulp of the steps' "
          f"({gap:.3g} of its max); logits {logits_gap:.3g} of their max "
          f"from the steps', argmaxes differ at "
          f"{int((clear & ~same).sum())} clear positions")
    if control:
        check(late_beyond > 0, f"{label}: layer 0's attention one position "
              f"late lies within one bf16 ulp of the steps' ({late_gap:.3g} "
              "of its max)")
    out = dict(attention_gap=gap, attention_bit_equal=bool(diff.max() == 0),
               late_attention_gap=late_gap, late_beyond_share=late_beyond,
               logits_gap=logits_gap, clear_positions=int(clear.sum()),
               positions=B * k)
    print(f"{label}: a {B} x {k} verify against T=1 steps on the same "
          f"cache: layer 0's attention within one bf16 ulp of the "
          f"{'kernel 3' if hm else 'plain kernel 8'} steps' ({gap:.3g} of "
          f"its max; one position late {late_gap:.3g}, beyond the ulp at a "
          f"share {late_beyond:.3g}); through "
          f"{len(eng.params.blocks)} layers logits {out['logits_gap']:.3g} "
          f"of max|logits| from the {'kernel 3' if hm else 'kernel 8'} "
          f"steps', argmaxes equal at the {out['clear_positions']} of "
          f"{B * k} positions clear of a near-tie", flush=True)
    return out

# ---------------------------------------------------------------------------
# Phase 11: speculative serving
# ---------------------------------------------------------------------------

# the model: benchserve.py:95-110's Markov substrate (BENCH_SUBSTRATE=
# markov) at Llama-2-7B's full width, quantized through
# quantize_model(W8A8): a planted first-order chain over tokens [2,
# SPEC_V_EFF) with cycles of ~SPEC_CYCLE tokens, its blocks one shared set
# of small random arrays, logit margin 30, so greedy output walks the chain
# and a prompt that walks it makes n-grams recur; at SPEC_LAYERS of the 32
# layers (a depth cut for the time limit, made with QUIK's phases)
SPEC_V_EFF, SPEC_CYCLE = 512, 16
SPEC_LAYERS = 16
SPEC_K, SPEC_NGRAM, SPEC_WINDOW_R = 4, 3, 8
# the script through an engine in turn: plain windows, spec windows,
# step_serve (adaptive), async plain windows
SPEC_RUNS = ("plain", "spec", "serve", "async")
# phase 9's pools, with speculation
# (label, attn_impl, KV type, warmup first, runs): the warmed pool asserts
# that serving after warmup captures no graph; the other captures its
# graphs in its first windows (the smoke's time limit holds one warmup).
# step_serve runs on the int8 pool only: on the chain's traffic it never
# leaves spec mode (acceptance 1), so on the bf16 pool it would repeat the
# spec run call for call (25 s of the limit); async windows too, where
# they repeat the plain run's windows (a cut for the time limit)
SPEC_POOLS = [(SPEC_LABELS[0], "auto", "bfloat16", False,
               ("plain", "spec")),
              (SPEC_LABELS[1], "flash", "int8", True, SPEC_RUNS)]
# a greedy step is a near-tie where the plain run's chosen token holds less
# than half the probability: another token may hold as much, and a verify
# row's logits may differ from a T=1 step's by ulps (kernel 2's plan
# follows M)
NEAR_TIE_LP = math.log(0.5)
# the snapshot check: a small pool of the same model and script, more
# requests than slots (SNAP_SAMPLED of them sampled), snapshotted after
# SNAP_AFTER calls while some are still queued
SNAP_SLOTS, SNAP_REQUESTS, SNAP_SAMPLED, SNAP_AFTER = 8, 16, 4, 2


def markov_model(dev):
    """The Markov 7B model on the card, at SPEC_LAYERS of Llama-2-7B's 32
    layers (full width): (cfg, params, specs, succ, host s of the state
    and of quantize_model). The state's arrays go to the card once
    (substrate.device_state: one block's)."""
    import dataclasses

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.quantize import quantize_model
    from mixq_tpu_torch.utils.substrate import (device_state,
                                                make_markov_state)
    from mixq_tpu_torch.utils.testing import DictSource

    cfg = dataclasses.replace(llama2_7b(), num_hidden_layers=SPEC_LAYERS)
    t0 = time.perf_counter()
    state, succ = make_markov_state(cfg, v_eff=SPEC_V_EFF, seed=0,
                                    mean_cycle=SPEC_CYCLE, share_blocks=True)
    t1 = time.perf_counter()
    params, specs = quantize_model(DictSource(device_state(state, dev)), cfg,
                                   QuantConfig.w8a8(), device=dev)
    torch.cuda.synchronize()
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return cfg, params, specs, succ, dict(
        state_s=t1 - t0, quantize_s=time.perf_counter() - t1)


def spec_script(succ, seed=1):
    """Phase 9's script shape (cb_script) with chain-walk prompts: 192
    requests, prompts of 16-256 tokens, each a walk of the planted chain
    from a random token, budgets of 16-128, CB_SAMPLED sampling, CB_STOPPED
    with a stop set (the 4th token the chain gives after the prompt), the
    arrivals per window."""
    import random

    from mixq_tpu_torch.engine import SamplingParams

    rng = random.Random(seed)

    def walk(t, n):
        out = []
        for _ in range(n):
            out.append(t)
            t = int(succ[t])
        return out

    reqs = [dict(prompt=walk(rng.randrange(2, SPEC_V_EFF),
                             rng.randint(*CB_PROMPT)),
                 budget=rng.randint(*CB_NEW), sampling=None, stop=None)
            for _ in range(CB_REQUESTS)]
    for i in rng.sample(range(CB_REQUESTS), CB_SAMPLED):
        reqs[i]["sampling"] = SamplingParams(**CB_SAMPLING)
    greedy = [i for i, r in enumerate(reqs) if r["sampling"] is None]
    stopped = sorted(rng.sample(greedy, CB_STOPPED))
    for i in stopped:
        reqs[i]["stop"] = [walk(reqs[i]["prompt"][-1], 5)[4]]
    arrivals, left = [], CB_REQUESTS
    while left:
        n = min(left, sum(rng.random() < 0.5 for _ in range(CB_BURST)))
        arrivals.append(n)
        left -= n
    return reqs, arrivals, stopped, walk


def spec_engine(dev, params, cfg, specs, attn_impl, kv_dtype, slots=None):
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        params, cfg, dataclasses.replace(specs, attn_impl=attn_impl),
        EngineConfig(max_batch_size=slots or CB_SLOTS, max_seq_len=CB_SEQ,
                     prefill_chunk=CB_PREFILL_CHUNK, kv_dtype=kv_dtype,
                     spec_k=SPEC_K, spec_ngram=SPEC_NGRAM,
                     spec_window_r=SPEC_WINDOW_R), device=dev)


def spec_run(eng, reqs, arrivals, how):
    """The script through `how` ("plain": step_window, "spec":
    step_spec_window, "serve": step_serve, "async": step_window_async,
    drained at the end): the requests of call w arrive before call w.
    Returns the records by request index, each call's wall ms, the spec
    counters of the run, the verify rows (R x active slots of each spec
    window) and the tokens the card emitted in them (a slot that finished
    mid-window included, as JAX's gain counts them)."""
    step = {"plain": eng.step_window, "spec": eng.step_spec_window,
            "serve": eng.step_serve, "async": eng.step_window_async}[how]
    eng.spec_stats = dict.fromkeys(eng.spec_stats, 0)
    rid_of, records, calls, rows, emitted = {}, {}, [], 0, 0.0
    nxt, w = 0, 0
    while nxt < len(reqs) or eng.has_work:
        for _ in range(arrivals[w] if w < len(arrivals) else 0):
            r = reqs[nxt]
            rid_of[eng.add_request(r["prompt"], r["budget"],
                                   sampling=r["sampling"],
                                   stop_token_ids=r["stop"])] = nxt
            nxt += 1
        w += 1
        forwards = eng.spec_stats["forwards"]
        t0 = time.perf_counter()
        n = step()
        calls.append((time.perf_counter() - t0) * 1e3)
        if eng.spec_stats["forwards"] > forwards:
            rows += SPEC_WINDOW_R * n
            emitted += eng._last_spec_gain * SPEC_WINDOW_R * n
        for rid, rec in eng.finished_records().items():
            records[rid_of[rid]] = rec
        check(w < 100000, f"{how}: the script did not drain")
    if how == "async":
        eng.drain_async()
        for rid, rec in eng.finished_records().items():
            records[rid_of[rid]] = rec
    return records, calls, dict(eng.spec_stats), rows, emitted


def first_near_tie(lps):
    return next((i for i, lp in enumerate(lps) if lp < NEAR_TIE_LP),
                len(lps))


def spec_profile(eng, tag, spec, want):
    """One window of the engine's live pool (its R steps or spec rounds)
    under the profiler, up to 3 windows until one shows every kernel run
    of `want` (`card_trace`; its primer, as WindowProfile's, is an eager
    step or round of the same kind from the window's own state, which is
    then put back: it writes the KV positions the window's first step
    writes, with the same values): the kernels the card ran (by
    launch-count key), device ms a step or round (CUPTI over the window's
    block), its split by kernel (kernel 1, kernel 2, kernel 3, kernel 8,
    the rest: the glue and, on the batch-major pool, the verify's
    `attend`), the busy share and the top kernels."""
    from mixq_tpu_torch.kernels import block_events, card_trace

    bufs = [eng._state] + ([eng._hist, eng._hlen] if spec else [])

    def primer():
        with torch.inference_mode():
            saved = [t.clone() for t in bufs]
            eng._col.zero_()
            (eng._spec_round if spec else eng._step)(False)
            for t, c in zip(bufs, saved):
                t.copy_(c)

    def run():
        eng._run_window(spec)

    n = SPEC_WINDOW_R if spec else eng._window_r
    parts = {"kernel 1": "rmsnorm_quant", "kernel 2": "mix_gemm_kernel",
             "kernel 3": "flash_decode_kernel",
             "kernel 8": "decode_attention_kernel"}
    for attempt in range(3):
        torch.cuda.synchronize()
        with torch.inference_mode(), card_trace(0.05, primer) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ran = ran_on_card(prof)
        if all(ran.get(k, 0) >= v for k, v in want.items()):
            break
    check(all(ran.get(k, 0) == v for k, v in want.items()),
          f"{tag}: the card ran {ran}, want {want} a window")
    by_name, split = {}, dict.fromkeys(list(parts) + ["rest"], 0.0)
    for e in block_events(prof):
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + e.self_device_time_total)
        key = next((k for k, pat in parts.items() if pat in e.name), "rest")
        split[key] += e.self_device_time_total / n / 1e3
    dev_us = sum(us for _, us in by_name.values())
    check(0 < dev_us <= wall_us, f"{tag}: device time {dev_us} us in a "
          f"block of {wall_us} us")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return dict(ran=ran, windows_tried=attempt + 1, steps=n,
                device_ms_per_step=dev_us / n / 1e3,
                device_busy_share=dev_us / wall_us,
                wall_ms_per_step=wall_us / n / 1e3, split_ms=split,
                top_kernels_us_per_step=[(name[:60], c, us / n)
                                         for name, (c, us) in top])


def spec_pool(dev, params, cfg, specs, label, attn_impl, kv_dtype, warm,
              how_runs, reqs, arrivals):
    """Phase 11 on one pool: warmup (`warm`), the runs `how_runs` (plain
    first), the greedy-token checks, the verify against T=1 steps, the
    profiled windows; the engine is freed when it returns."""
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.reset_peak_memory_stats()
    eng = spec_engine(dev, params, cfg, specs, attn_impl, kv_dtype)
    check(eng.cache.head_major == (kv_dtype == "int8"),
          f"{label}: the pool's layout")
    pool = {"attn_impl": attn_impl, "kv_dtype": kv_dtype, "slots": CB_SLOTS,
            "positions": CB_SEQ, "spec_k": SPEC_K, "spec_ngram": SPEC_NGRAM,
            "spec_window_r": SPEC_WINDOW_R, "window_r": eng._window_r,
            "head_major": eng.cache.head_major}
    # the main path, counts set to 0 first: warmup (the kernels, JAX's
    # admission buckets, the four graphs), then the four runs
    reset_launch_counts()
    if warm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        programs = eng.warmup()
        torch.cuda.synchronize()
        pool.update(warmup_s=time.perf_counter() - t0,
                    warmup_programs=programs, warmup_captures=eng.captures)
        check(eng.captures == 4, f"{label}: warmup captured "
              f"{eng.captures}")
    runs = {}
    for how in how_runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs, calls, stats, rows, emitted = spec_run(eng, reqs, arrivals,
                                                     how)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(sorted(recs) == list(range(CB_REQUESTS)),
              f"{label} {how}: {len(recs)} of {CB_REQUESTS} finished")
        tokens = sum(len(r["tokens"]) for r in recs.values())
        ms = sorted(calls)
        run = dict(tokens=tokens, calls=len(calls), wall_s=wall,
                   tok_per_s=tokens / wall,
                   ms_per_window_median=ms[len(ms) // 2],
                   ms_per_window_p90=ms[int(0.9 * (len(ms) - 1))],
                   **stats)
        if stats["forwards"]:
            run.update(acceptance=stats["accepted"] / max(stats["drafted"],
                                                          1),
                       verify_rows=rows, gain=emitted / max(rows, 1))
        runs[how] = (recs, run)
        print(f"spec {label} {how}: {tokens} tokens in {wall:.2f} s, "
              f"{run['tok_per_s']:.1f} tok/s over {len(calls)} calls; ms "
              f"per window median {run['ms_per_window_median']:.2f}, p90 "
              f"{run['ms_per_window_p90']:.2f}"
              + (f"; drafted {stats['drafted']}, accepted "
                 f"{stats['accepted']} (rate {run['acceptance']:.4f}), "
                 f"gain {run['gain']:.3f} emitted per verify row over "
                 f"{stats['forwards']} verify forwards" if stats["forwards"]
                 else ""), flush=True)
    counts = {k: v for k, v in launch_counts().items() if v}
    if warm:
        check(eng.captures == 4, f"{label}: {eng.captures - 4} captures "
              "after warmup")
        pool["captures_after_warmup"] = eng.captures - 4
    else:
        pool["captures_in_runs"] = eng.captures
    pool["runs"] = {how: run for how, (_, run) in runs.items()}
    spec = pool["runs"]["spec"]
    check(spec["drafted"] > 0, f"{label}: no draft token")
    # every request ends at its budget or its stop token; greedy tokens of
    # the spec, serve and async runs equal the plain run's up to each
    # request's first near-tie
    plain = runs["plain"][0]
    for i, r in enumerate(reqs):
        for how, (recs, _) in runs.items():
            toks = recs[i]["tokens"]
            stop = bool(r["stop"]) and toks[-1] in r["stop"]
            check(len(toks) == r["budget"] or (stop and len(toks)
                                               <= r["budget"]),
                  f"{label} {how}: request {i} ended after {len(toks)} of "
                  f"{r['budget']} tokens")
    held, ties = 0, []
    for i, r in enumerate(reqs):
        if r["sampling"] is not None:
            continue
        n = first_near_tie(plain[i]["logprobs"])
        if n < len(plain[i]["tokens"]):
            ties.append((i, n))
        for how in how_runs[1:]:
            got = runs[how][0][i]["tokens"]
            check(got[:n] == plain[i]["tokens"][:n],
                  f"{label} {how}: greedy request {i} leaves the plain "
                  f"run before its first near-tie ({n})")
        held += 1
    pool.update(greedy_held=held, near_ties=ties,
                min_greedy_logprob=min(
                    min(plain[i]["logprobs"]) for i, r in enumerate(reqs)
                    if r["sampling"] is None))
    # the verify against T=1 steps on the live cache (the Markov model's
    # blocks sit below the residual's bf16 resolution, so phase 9's random
    # weights hold the control)
    pool["verify_vs_steps"] = verify_vs_steps(eng, cfg, label,
                                              control=False)
    # kernel 3's launches per verify forward: spec_k x L on the int8 pool
    L = cfg.num_hidden_layers
    attn = attn_modes(cfg, eng.specs, kv_dtype, CB_SEQ)
    # a full pool for it, admitted in groups of CB_BURST (phase 3 held
    # kernels 1 and 2 at such an admission's rows) through plain windows,
    # budgets up to the room
    for g in range(0, CB_SLOTS, CB_BURST):
        for i in range(g, g + CB_BURST):
            eng.add_request(reqs[i]["prompt"], CB_SEQ)
        eng.step_window()
    reset_launch_counts()
    with torch.inference_mode():
        eng._verify(torch.zeros((eng.n_slots, SPEC_K), dtype=torch.int32,
                                device=dev), False)
    torch.cuda.synchronize()
    one = launch_counts()
    want_k3 = SPEC_K * L if eng.cache.head_major else 0
    check(one["flash_decode"] == want_k3 and one["decode_attention"] == 0,
          f"{label}: a verify forward launched kernel 3 "
          f"{one['flash_decode']} times, want {want_k3}")
    pool["verify_kernel3_launches"] = one["flash_decode"]
    # one verify round and one plain step profiled, device ms by kernel
    want_spec = expect_launches("W8A8", cfg, SPEC_WINDOW_R, 0, ())
    if eng.cache.head_major:
        want_spec["flash_decode"] = SPEC_K * L * SPEC_WINDOW_R
    want_plain = expect_launches("W8A8", cfg, eng._window_r, eng._window_r,
                                 attn)
    from mixq_tpu_torch.kernels import UNNAMED
    prof, ran = {}, {}
    for what, spec_win, want in (("verify round", True, want_spec),
                                 ("plain step", False, want_plain)):
        prof[what] = spec_profile(
            eng, f"spec_{kv_dtype}_{what.split()[0]}", spec_win,
            {k: v for k, v in want.items() if k not in UNNAMED})
        for k, v in prof[what]["ran"].items():
            ran[k] = ran.get(k, 0) + v
    pool["profile"] = prof
    pool["serve"] = {"executed": ran, "launches": counts}
    pool["launches"] = counts
    pool["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 30)
    vr, ps = prof["verify round"], prof["plain step"]
    print(f"spec {label}: "
          + (f"warmup {pool['warmup_s']:.1f} s ({programs} programs, "
             f"{eng.captures} graphs), no capture after it; " if warm else
             f"{eng.captures} graphs captured in its first windows; ")
          + f"{held} greedy requests equal across the "
          f"{', '.join(how_runs)} runs up to their first near-tie "
          f"({len(ties)} near-ties, least greedy logprob "
          f"{pool['min_greedy_logprob']:.3g}); a verify forward launches "
          f"kernel 3 {one['flash_decode']} times; device ms a verify round "
          f"{vr['device_ms_per_step']:.3f} (busy "
          f"{vr['device_busy_share']:.3f}) by kernel {vr['split_ms']}, a "
          f"plain step {ps['device_ms_per_step']:.3f} by kernel "
          f"{ps['split_ms']}; spec/plain tok/s "
          f"{spec['tok_per_s'] / pool['runs']['plain']['tok_per_s']:.3f}; "
          f"peak memory {pool['max_memory_allocated_gib']:.2f} GiB; "
          f"launches {counts}", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return pool


def spec_snapshot(dev, params, cfg, specs, reqs):
    """A small int8 flash spec pool (SNAP_SLOTS slots) through step_serve
    on SNAP_REQUESTS of the script's requests (SNAP_SAMPLED of them
    sampled): snapshotted after call SNAP_AFTER, with requests still
    queued (asserted), and restored into a new engine, it continues with
    the uninterrupted run's records, bit-equal (tokens and logprobs,
    sampled rows included; the queued requests keep their ids, budgets and
    stop sets)."""
    import dataclasses
    import shutil
    import tempfile

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

    sub = ([r for r in reqs if r["sampling"] is not None][:SNAP_SAMPLED]
           + [r for r in reqs if r["sampling"] is None][
               :SNAP_REQUESTS - SNAP_SAMPLED])
    queued = []

    def serve(snap_dir=None):
        eng = spec_engine(dev, params, cfg, specs, "flash", "int8",
                          SNAP_SLOTS)
        ids = [eng.add_request(r["prompt"], r["budget"],
                               sampling=r["sampling"],
                               stop_token_ids=r["stop"]) for r in sub]
        recs, calls, snap_s = {}, 0, None
        while eng.has_work:
            eng.step_serve()
            recs.update(eng.finished_records())
            calls += 1
            if calls == SNAP_AFTER and snap_dir is not None:
                queued.append(eng.stats()["queued"])
                t0 = time.perf_counter()
                eng.snapshot(snap_dir)
                del eng
                gc.collect()
                eng = ContinuousBatchingEngine.restore(
                    snap_dir, params, cfg,
                    dataclasses.replace(specs, attn_impl="flash"),
                    EngineConfig(max_batch_size=SNAP_SLOTS,
                                 max_seq_len=CB_SEQ,
                                 prefill_chunk=CB_PREFILL_CHUNK,
                                 kv_dtype="int8", spec_k=SPEC_K,
                                 spec_ngram=SPEC_NGRAM,
                                 spec_window_r=SPEC_WINDOW_R), device=dev)
                torch.cuda.synchronize()
                snap_s = time.perf_counter() - t0
        recs.update(eng.finished_records())
        return [recs[i] for i in ids], snap_s

    ref, _ = serve()
    tmp = tempfile.mkdtemp(prefix="mixq_snapshot_")
    try:
        got, snap_s = serve(os.path.join(tmp, "pool"))
        nbytes = sum(os.path.getsize(os.path.join(tmp, "pool", f))
                     for f in os.listdir(os.path.join(tmp, "pool")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(queued[0] > 0, f"snapshot: no request queued after call "
          f"{SNAP_AFTER}")
    differ = [i for i, (a, b) in enumerate(zip(got, ref)) if a != b]
    check(not differ, f"snapshot: requests {differ} differ after restore")
    out = dict(slots=SNAP_SLOTS, requests=SNAP_REQUESTS,
               sampled=sum(r["sampling"] is not None for r in sub),
               snapshot_after_calls=SNAP_AFTER, queued_at_snapshot=queued[0],
               snapshot_restore_s=snap_s, snapshot_bytes=nbytes,
               bit_equal=True)
    print(f"spec snapshot: {SNAP_REQUESTS} requests ({out['sampled']} "
          f"sampled) on {SNAP_SLOTS} int8 flash slots, snapshot after "
          f"{SNAP_AFTER} calls with {queued[0]} queued ("
          f"{nbytes / 2 ** 30:.2f} GiB, {snap_s:.1f} s with the restore) "
          "continues bit-equal to the uninterrupted run", flush=True)
    return out


def spec_generate(dev, params, cfg, specs, walk):
    """generate_speculative on one 64-token chain prompt against greedy
    generate on the same engine (bf16 KV): tokens equal up to the first
    near-tie of generate's logprobs; forwards per token."""
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.engine.speculative import generate_speculative

    eng = InferenceEngine(params, cfg,
                          dataclasses.replace(specs, attn_impl="auto"),
                          EngineConfig(max_seq_len=CB_SEQ, prefill_chunk=64),
                          device=dev)
    prompt = walk(7, 64)
    t0 = time.perf_counter()
    toks, stats = generate_speculative(eng, prompt, max_new_tokens=64,
                                       ngram=SPEC_NGRAM, k=SPEC_K)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    ref, lps = eng.generate([prompt], max_new_tokens=64,
                            return_logprobs=True)
    n = first_near_tie(lps[0])
    check(toks[:n] == ref[0][:n] and len(toks) == 64,
          f"generate_speculative leaves greedy generate before its first "
          f"near-tie ({n})")
    out = dict(tokens=len(toks), equal_up_to=n, host_s=spec_s,
               forwards_per_token=stats["forwards"] / len(toks), **stats)
    print(f"spec generate_speculative: 64 tokens equal greedy generate's "
          f"(up to {n}); {stats['forwards']} forwards "
          f"({out['forwards_per_token']:.3f} a token), drafted "
          f"{stats['drafted']}, accepted {stats['accepted']}", flush=True)
    return out


def spec_phase(dev):
    """Phase 11: speculative serving of the Markov Llama-2-7B model on
    phase 9's pools (spec_pool), the snapshot check (spec_snapshot) and
    generate_speculative (spec_generate)."""
    cfg, params, specs, succ, built = markov_model(dev)
    reqs, arrivals, stopped, walk = spec_script(succ)
    out = {"model": dict(v_eff=SPEC_V_EFF, mean_cycle=SPEC_CYCLE,
                         source="benchserve.py:95-110", **built),
           "script": dict(requests=CB_REQUESTS,
                          arrivals_per_window=arrivals,
                          prompt_tokens=sum(len(r["prompt"]) for r in reqs),
                          budget_tokens=sum(r["budget"] for r in reqs),
                          sampled=[i for i, r in enumerate(reqs)
                                   if r["sampling"]], stopped=stopped),
           "pools": {}}
    print(f"spec model: Markov state {built['state_s']:.1f} s, "
          f"quantize_model {built['quantize_s']:.1f} s", flush=True)
    for label, attn_impl, kv_dtype, warm, how_runs in SPEC_POOLS:
        out["pools"][label] = spec_pool(dev, params, cfg, specs, label,
                                        attn_impl, kv_dtype, warm, how_runs,
                                        reqs, arrivals)
    out["snapshot"] = spec_snapshot(dev, params, cfg, specs, reqs)
    out["generate_speculative"] = spec_generate(dev, params, cfg, specs,
                                                walk)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 10: evaluation
# ---------------------------------------------------------------------------

# the quality gate of BASELINE.md: W8A8O16 PPL within 0.1 of FP16
PPL_GATE = 0.1
# the card's PPL against the CPU's (the plain versions), each (config, KV
# type): within the larger of the config's own int8-vs-bf16 KV gap in the
# same run (on the CPU) and this share of the PPL
PPL_REL_TOL = 1e-3
# ... but the tiny gate's configs with A4 activations (mix4, mix4_g64,
# mix4_full_g64, quik) take this share: the rest of the forward's f32 ops
# (attend, the norms' row sums) run in another order on the card, and a
# bf16 input that lands an ulp apart flips an int4 level now and then.
# Readings on an H100 (segment 0): up to 1.26e-3 of the PPL (mix4_g64, bf16
# KV, 4.5e-3 from the CPU against a KV gap of 3.8e-3), and the same with
# the plain versions run on the card (1.31e-3): the glue's gap, not the
# kernels'. The KV gap (3.8e-3 and 4.3e-3 for mix4_g64 and mix4) lies
# under that noise and cannot be the control; kernels 1, 2 and A are held
# directly at these shapes in phase 3 (kernel_eval_shapes).
A4_PPL_REL_TOL = 2.5e-3
# the control the A4 limit is held under on every run: the CPU's PPL with
# the outlier term of one linear dropped, the last layer's q projection
# (on an H100: moved 0.018 to 0.027, 2.1x the limit or more)
A4_CONFIGS = ("mix4", "mix4_g64", "mix4_full_g64", "quik")
# the 2-layer, full-width copy of the 7B gate held on the card against the
# CPU: its windows (n_ctx 256) on segment 0. Its PPL is mostly the chain's
# (30.18 of 30.21: the blocks move it by ~0.03), so this check sees the
# glue and gross faults; phase 3 holds the kernels at these shapes.
TWO_LAYER_WINDOWS = 2
# the 7B offline tasks (examples/lm_eval_run.py's sizes)
CLOZE = dict(n_items=16, ctx_len=12, cont_len=3)
COMPLETION = dict(n_items=8, ctx_len=12, gen_len=3)
TASK_MIN = 0.9
# the 7B gate's FP16 PPL against its chain's, 1 + (V - 1) e^-margin: the
# blocks' noise (block_scale) and the readout's ridge move it a little (a
# 256-wide, 3-layer copy on the CPU read 1.7% above it)
CHAIN_PPL_TOL = 0.05


def drop_q_outliers(params):
    """`params` with the outlier term of the last layer's q projection
    dropped (its fp weight rows zeroed): A4_PPL_REL_TOL's control."""
    last = params.blocks[-1]
    wq = last.attn.wq
    last = last._replace(attn=last.attn._replace(
        wq=wq._replace(w_outlier=torch.zeros_like(wq.w_outlier))))
    return params._replace(blocks=params.blocks[:-1] + (last,))


def ppl_card_vs_cpu(params, cfg, specs, seg, n_ctx, windows, what,
                    rel=PPL_REL_TOL, control=False):
    """PPL of `seg` with bf16 and int8 KV on the card (the kernels) and on
    a CPU copy of the params (the plain versions), held within the larger
    of the CPU's int8-vs-bf16 KV gap and `rel` of the PPL; with `control`,
    the limit is also held under the CPU's PPL move with
    drop_q_outliers. The rows' checks are asserted at eval_phase's end."""
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.eval import compute_perplexity

    cpu_params = params_to(params, "cpu")

    def ppl(p, kv):
        return compute_perplexity(p, cfg, seg, specs, n_ctx=n_ctx,
                                  batch_size=8, kv_dtype=kv,
                                  max_windows=windows).ppl

    t0 = time.perf_counter()
    got = {kv: (ppl(params, kv), ppl(cpu_params, kv))
           for kv in ("bfloat16", "int8")}
    ctrl = (abs(ppl(drop_q_outliers(cpu_params), "bfloat16")
                - got["bfloat16"][1]) if control else None)
    secs = time.perf_counter() - t0
    kv_gap = abs(got["int8"][1] - got["bfloat16"][1])
    rows = []
    for kv, (card, cpu) in got.items():
        tol = max(kv_gap, rel * cpu)
        rows.append(dict(
            what=what, kv=kv, card=card, cpu=cpu, diff=abs(card - cpu),
            tol=tol, rel=rel, kv_gap_cpu=kv_gap,
            kv_gap_card=abs(got["int8"][0] - got["bfloat16"][0]),
            control=ctrl, ok=(abs(card - cpu) <= tol
                              and (ctrl is None or tol < ctrl))))
    print(f"card vs cpu {what}: " + "; ".join(
        f"{r['kv']} {r['card']:.6f} / cpu {r['cpu']:.6f} (|d| "
        f"{r['diff']:.3g}, limit {r['tol']:.3g})" for r in rows)
        + (f"; control (one linear's outlier term dropped) {ctrl:.3g}"
           if control else "") + f"; {secs:.1f} s", flush=True)
    return rows


def tiny_gate_phase(dev, card):
    """examples/realistic_gate_torch.run with JAX's defaults on the card,
    each config's segment 0 also held against the CPU."""
    import realistic_gate_torch as tiny_gate

    from mixq_tpu_torch.utils.substrate import substrate_cfg

    args = tiny_gate.parser().parse_args([])
    cfg = substrate_cfg(args.preset)
    vs_cpu, splits = [], {}

    def on_config(name, params, specs, segments):
        a4 = name in A4_CONFIGS
        vs_cpu.extend(ppl_card_vs_cpu(
            params, cfg, specs, segments[0], args.n_ctx, args.windows,
            f"tiny {name}", rel=A4_PPL_REL_TOL if a4 else PPL_REL_TOL,
            control=a4))
        if name in ("mix4_g64", "mix4_full_g64"):   # kernel A's new shapes
            splits[name] = batch_split(params, cfg, specs, segments[0],
                                       args.n_ctx, args.batch,
                                       f"tiny_{name}", card)

    t0 = time.perf_counter()
    rows = tiny_gate.run(args, on_config)
    out = {"rows": rows, "card_vs_cpu": vs_cpu, "splits": splits,
           "host_s": time.perf_counter() - t0}
    train = rows[0]
    check(train["loss"] < 0.75 * train["chance"],
          f"tiny gate: training loss {train['loss']} not below 0.75 ln V")
    check(rows[1]["drift"] < 0.02,
          f"tiny gate: planting moved the fp logits by {rows[1]['drift']}")
    hits = rows[2]["per_layer_hits"]
    check(all(h == args.n_outliers for h in hits.values()),
          f"tiny gate: warmup found {hits} of {args.n_outliers} planted "
          "channels per layer")
    cells = {(r["config"], r["kv"]): r for r in rows if "config" in r}
    out["gate"] = {name: cells[(name, "bfloat16")]["delta_vs_fp16"]
                   for name in ("mix8", "mix8_warmed")}
    out["monotone"] = rows[-1]
    print(f"tiny gate: trained {train['steps']} steps in "
          f"{train['seconds']:.1f} s to loss {train['loss']:.4f} (chance "
          f"{train['chance']:.4f}); W8A8 paired deltas vs the "
          f"{PPL_GATE} of BASELINE.md: {out['gate']}; monotone gate "
          f"{rows[-1]}; {out['host_s']:.1f} s", flush=True)
    return out


def split_profile(fn, tag):
    """Device ms of `fn` in the block of a kernels.card_trace window with
    host activity (`fn` once more as its primer, so CUPTI's loss at a
    window's start falls there), split into kernel 1, kernels 2 and A, the
    f32 prefill `attend` (the device time under the decoder's
    PREFILL_ATTEND ranges in the block), QUIK's activation glue (under
    quik_linear's QUIK_QUANT ranges) and the rest, with the port's
    kernels the card ran (ran_on_card's keys)."""
    from mixq_tpu_torch.kernels import block_events, card_trace
    from mixq_tpu_torch.models.decoder import PREFILL_ATTEND
    from mixq_tpu_torch.ops.mixed_linear import QUIK_QUANT

    torch.cuda.synchronize()
    with card_trace(primer=fn, cpu=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the ranges' device-side annotations span their kernels: not counted
    kernels = [e for e in block_events(prof)
               if e.name not in (PREFILL_ATTEND, QUIK_QUANT)]
    total = sum(e.self_device_time_total for e in kernels)

    def named(*keys):
        return sum(e.self_device_time_total for e in kernels
                   if any(k in e.name for k in keys))

    def device_total(e):
        if hasattr(e, "device_time_total"):
            return e.device_time_total
        return e.cuda_time_total

    attend_us = sum(device_total(e)
                    for e in block_events(prof, host_range=PREFILL_ATTEND))
    quant_us = sum(device_total(e)
                   for e in block_events(prof, host_range=QUIK_QUANT))
    k1 = named("rmsnorm_quant_regs", "rmsnorm_quant_loop")
    k2 = named("mix_gemm_kernel", "mix_gemm_zp_kernel")
    out = dict(device_ms=total / 1e3, wall_ms=wall * 1e3,
               kernel1_ms=k1 / 1e3, kernel2_and_A_ms=k2 / 1e3,
               attend_ms=attend_us / 1e3 if attend_us else None,
               quik_quant_ms=quant_us / 1e3 if quant_us else None,
               rest_ms=(total - k1 - k2 - attend_us - quant_us) / 1e3,
               busy_share=total / 1e6 / wall,
               ran=ran_on_card(prof))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=30))
    return out


def batch_split(params, cfg, specs, seg, n_ctx, batch, tag, card):
    """One window batch (`batch` windows of n_ctx, bf16 KV) of
    compute_perplexity, run once, then profiled (split_profile)."""
    from mixq_tpu_torch.eval import compute_perplexity

    def one_batch():
        compute_perplexity(params, cfg, seg, specs, n_ctx=n_ctx,
                           batch_size=batch, kv_dtype="bfloat16",
                           max_windows=batch)

    one_batch()
    split = split_profile(one_batch, f"eval_{tag}")
    print(f"{tag} window batch ({batch} x {n_ctx}) device ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()
                      if k != "ran" and v is not None)
          + f"; the port's kernels run: "
          f"{ {k: n for k, n in split['ran'].items() if n} } on {card}",
          flush=True)
    return split


def offline_tasks(params, cfg, specs, gate, label, profile_decode=False):
    """Cloze and completion (eval/offline_tasks.py) through MixQLM on a
    chain walk, as examples/lm_eval_run.py runs them; with profile_decode,
    the completion runs in a card_trace window and the kernels the card
    ran are counted by name."""
    import numpy as np

    from mixq_tpu_torch.eval.lm_eval_adaptor import MixQLM
    from mixq_tpu_torch.eval.offline_tasks import (
        IntTokenizer, build_cloze_task, build_completion_task,
        evaluate_cloze, evaluate_completion)
    from mixq_tpu_torch.kernels import card_trace

    corpus = np.asarray(gate.walk(5, 2001), np.int32)
    lm = MixQLM(params, cfg, specs, IntTokenizer(), batch_size=8,
                max_length=128)
    t0 = time.perf_counter()
    out = {"cloze": evaluate_cloze(lm, build_cloze_task(corpus, **CLOZE))}
    items = build_completion_task(corpus, **COMPLETION)
    if profile_decode:
        with card_trace() as prof:
            out["completion"] = evaluate_completion(lm, items)
        out["ran"] = ran_on_card(prof)
    else:
        out["completion"] = evaluate_completion(lm, items)
    out["host_s"] = time.perf_counter() - t0
    print(f"offline tasks {label}: acc {out['cloze']['acc']} "
          f"exact_match {out['completion']['exact_match']}"
          + (f", kernel 8 ran {out['ran']['decode_attention']} times"
             if profile_decode else "") + f" ({out['host_s']:.1f} s)",
          flush=True)
    return out


def gate_7b_phase(dev, card):
    """examples/gate_7b_torch.run at Llama-2-7B's full width and depth
    (fp16, mix8, mix4 and quik); on the way, the offline tasks on FP16 (the
    control) and W8A8O16, one window batch of each quantized config
    profiled, a W8A8O16 32-window batch timed, and a 2-layer copy of
    W8A8O16, W4A4O16 and QUIK W4A4 held on the card against the CPU."""
    import dataclasses

    import numpy as np

    import gate_7b_torch as gate7
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.eval import compute_perplexity
    from mixq_tpu_torch.quantize import quantize_model

    args = gate7.parser().parse_args([])
    out = {"tasks": {}, "card_vs_cpu": [], "splits": {}}

    def two_layers(name, gate):
        cfg2 = dataclasses.replace(gate.cfg, num_hidden_layers=2)
        qcfg = {"mix8": QuantConfig.w8a8(), "mix4": QuantConfig.w4a4(),
                "quik": QuantConfig.quik_w4a4()}[name]
        p2, specs2 = quantize_model(gate.src, cfg2, qcfg,
                                    calib_batches=gate.calib, device=dev)
        seg = gate.segments[0][:TWO_LAYER_WINDOWS * args.n_ctx + 1]
        out["card_vs_cpu"].extend(ppl_card_vs_cpu(
            p2, cfg2, specs2, seg, args.n_ctx, TWO_LAYER_WINDOWS,
            f"7b 2-layer {name}"))

    def on_config(name, params, specs, gate):
        cfg = gate.cfg
        if name == "fp16":
            out["tasks"]["fp16"] = offline_tasks(params, cfg, specs, gate,
                                                 "7b fp16 (control)")
            return
        two_layers(name, gate)
        seg = gate.segments[0]
        out["splits"][name] = batch_split(params, cfg, specs, seg,
                                          args.n_ctx, args.batch,
                                          f"7b_{name}", card)
        if name != "mix8":
            return
        long = np.asarray(gate.walk(13, 32 * args.n_ctx + 1), np.int32)
        timed = {}
        for B in (args.batch, 32, args.batch, 32):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute_perplexity(params, cfg, long, specs, n_ctx=args.n_ctx,
                               batch_size=B, kv_dtype="bfloat16",
                               max_windows=32)
            torch.cuda.synchronize()
            timed.setdefault(B, []).append(time.perf_counter() - t0)
        out["batch_timing"] = {
            f"batch {B}": dict(wall_s=min(ts), tokens_per_s=32 * args.n_ctx
                               / min(ts), runs_s=ts)
            for B, ts in timed.items()}
        print(f"7b mix8 bf16 KV, 32 windows of {args.n_ctx} at batch "
              f"{args.batch} and 32: {out['batch_timing']} on {card}",
              flush=True)
        out["tasks"]["mix8"] = offline_tasks(params, cfg, specs, gate,
                                             "7b mix8", profile_decode=True)

    t0 = time.perf_counter()
    out["rows"] = gate7.run(args, on_config)
    out["host_s"] = time.perf_counter() - t0
    rows = {(r["config"], r["kv"]): r for r in out["rows"] if "config" in r}
    # the chain's own PPL: the successor's logit is the margin, the other
    # V - 1 logits ~0 (the readout's zeros and the 1e-4 head rows of the
    # tokens off the chain), so p = e^m / (e^m + V - 1)
    cfg = gate7.model_cfg(args)
    out["chain_ppl"] = 1 + (cfg.vocab_size - 1) * math.exp(-args.margin)
    fp16 = rows[("fp16", "bfloat16")]["ppl_mean"]
    check(abs(fp16 - out["chain_ppl"]) <= CHAIN_PPL_TOL * out["chain_ppl"],
          f"7b gate: FP16 PPL {fp16}, the chain's {out['chain_ppl']}")
    for name in ("fp16", "mix8"):
        t = out["tasks"][name]
        out.setdefault("task_scores", {})[name] = (
            t["cloze"]["acc"], t["completion"]["exact_match"])
    acc, em = out["task_scores"]["mix8"]
    check(acc >= TASK_MIN and em >= TASK_MIN,
          f"7b mix8 offline tasks: acc {acc}, exact_match {em}")
    check(out["tasks"]["mix8"]["ran"]["decode_attention"] > 0,
          "7b mix8 completion: kernel 8 never ran")
    print(f"7b gate: {len(out['rows'])} rows in {out['host_s']:.1f} s; "
          f"tokens/s by config: " + ", ".join(
              f"{c} {kv} {r['tokens_per_s']}" for (c, kv), r in rows.items())
          + f"; offline tasks (acc, exact_match): {out['task_scores']}",
          flush=True)
    return out


def eval_phase(dev, card):
    """Phase 10: the trained tiny gate and the 32-layer Llama-2-7B gate
    through the quantized kernels, the wrappers' counts set to 0 just
    before and read just after."""
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = {"tiny": tiny_gate_phase(dev, card)}
    gc.collect()
    torch.cuda.empty_cache()
    out["7b"] = gate_7b_phase(dev, card)
    bad = [r for part in ("tiny", "7b") for r in out[part]["card_vs_cpu"]
           if not r["ok"]]
    check(not bad, "evaluation: PPL past its limit: " + "; ".join(
        f"{r['what']} {r['kv']}: card {r['card']}, cpu {r['cpu']} (limit "
        f"{r['tol']}, control {r['control']})" for r in bad))
    launches = launch_counts()
    for key in ("rmsnorm_quant", "mix_gemm.w8a8", "mix_gemm.w4",
                "mix_gemm.w4_grouped", "mix_gemm.w8a8_grouped",
                "mix_gemm.w4_zp", "mix_gemm.w8a8_zp", "decode_attention"):
        check(launches.get(key, 0) > 0,
              f"evaluation: {key} launched {launches.get(key, 0)} times")
    ran = {}
    for r in ([sp["ran"] for part in ("tiny", "7b")
               for sp in out[part]["splits"].values()]
              + [out["7b"]["tasks"]["mix8"]["ran"]]):
        for k, n in r.items():
            ran[k] = ran.get(k, 0) + n
    # the kernels line reads phase 10 as a serve run: the kernels the card
    # ran in its profiled windows, the wrappers' launches over the phase
    out["serve"] = {"executed": ran, "launches": launches}
    out["max_memory_allocated_gib"] = (torch.cuda.max_memory_allocated()
                                       / 2 ** 30)
    print(f"evaluation: wrapper launches {launches}; peak memory "
          f"{out['max_memory_allocated_gib']:.2f} GiB", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    import dataclasses

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import mixq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the mixq_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    from mixq_tpu_torch.kernels import MODULES, _build
    from mixq_tpu_torch.models.decoder import init_decoder_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"card: {card} (torch: {kind}, {torch.cuda.device_count()} "
          f"device(s), torch {torch.__version__}, CUDA {torch.version.cuda})",
          flush=True)
    report = {"card": card, "kind": kind}

    from mixq_tpu_torch.kernels import flash_decode as FD
    t0 = time.perf_counter()
    ptxas = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s for {len(ptxas)} kernel "
          "libraries", flush=True)
    for name, log in ptxas.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(sorted(set(regs)))[:400])
    A16_PTXAS.update(ptxas_by_mode(ptxas.get("w8a16", ""), "w8a16_kernel"))
    for (w4, grouped), r in A16_PTXAS.items():    # no spills on the W8 path
        check(w4 or " 0 bytes spill stores" in r.get("spills", ""),
              f"w8a16_kernel<W8, grouped={grouped}> spills: {r}")
    report["w8a16_ptxas"] = {f"w4={k[0]} grouped={k[1]}": v
                             for k, v in A16_PTXAS.items()}
    from mixq_tpu_torch.kernels import mix_gemm, w8a16
    # no instantiation of the int8-activation GEMM spills (a library built
    # before, in this process's checkout, reports "(cached)")
    MIX_PTXAS.update(ptxas_by_mode(ptxas.get("mix_gemm", ""),
                                   "mix_gemm_kernel"))
    check(ptxas.get("mix_gemm") == "(cached)" or len(MIX_PTXAS) == 4,
          f"mix_gemm: ptxas reported {len(MIX_PTXAS)} instantiations")
    for (w4, grouped), r in MIX_PTXAS.items():
        check(" 0 bytes spill stores" in r.get("spills", ""),
              f"mix_gemm_kernel<W4={w4}, grouped={grouped}> spills: {r}")
        # the zero-point mode is a template argument of its own: the MIX
        # instantiations keep their registers
        check(r.get("registers") == MIX_REGISTERS[(w4, grouped)],
              f"mix_gemm_kernel<W4={w4}, grouped={grouped}> uses "
              f"{r.get('registers')} registers, not "
              f"{MIX_REGISTERS[(w4, grouped)]}")
    # QUIK's zero-point kernel (W8 and packed W4) does not spill either
    ZP_PTXAS.update(ptxas_by_mode(ptxas.get("mix_gemm", ""),
                                  "mix_gemm_zp_kernel"))
    check(ptxas.get("mix_gemm") == "(cached)" or len(ZP_PTXAS) == 2,
          f"mix_gemm: ptxas reported {len(ZP_PTXAS)} zero-point "
          "instantiations")
    for (w4,), r in ZP_PTXAS.items():
        check(" 0 bytes spill stores" in r.get("spills", ""),
              f"mix_gemm_zp_kernel<W4={w4}> spills: {r}")
    report["mix_gemm_zp_ptxas"] = {f"w4={k[0]}": v
                                   for k, v in ZP_PTXAS.items()}
    report["mix_gemm_zp_clusters"] = {
        f"w4={w4}": mix_gemm._clusters(0, w4, False, True)
        for w4 in (False, True)}
    print(f"  mix_gemm_zp: {report['mix_gemm_zp_ptxas']}; clusters of 1..8 "
          f"blocks the card holds at once: {report['mix_gemm_zp_clusters']}",
          flush=True)
    # kernel 1's register kernel (one instantiation) does not spill
    log = ptxas.get("rmsnorm_quant", "")
    RMS_PTXAS.update(ptxas_by_mode(log, "rmsnorm_quant_regs"))
    check(log == "(cached)" or len(RMS_PTXAS) == 1,
          f"rmsnorm_quant: ptxas reported {len(RMS_PTXAS)} instantiations")
    for key, r in RMS_PTXAS.items():
        check(" 0 bytes spill stores" in r.get("spills", ""),
              f"rmsnorm_quant_regs<{key}> spills: {r}")
    report["rmsnorm_quant_ptxas"] = {
        f"threads={k[0]} chunks={k[1]}": v
        for k, v in sorted(RMS_PTXAS.items())}
    print(f"  rmsnorm_quant: {report['rmsnorm_quant_ptxas']}")
    # no instantiation of flash decode spills
    log = ptxas.get("flash_decode", "")
    FLASH_PTXAS.update(ptxas_by_mode(log, "flash_decode_kernel"))
    check(log == "(cached)" or len(FLASH_PTXAS) == 16,
          f"flash_decode: ptxas reported {len(FLASH_PTXAS)} instantiations")
    for (g, int8, cap), r in FLASH_PTXAS.items():
        check(" 0 bytes spill stores" in r.get("spills", ""),
              f"flash_decode_kernel<{g}, int8={int8}, softcap={cap}> "
              f"spills: {r}")
    report["flash_decode_ptxas"] = {
        f"g={k[0]} int8={k[1]} softcap={k[2]}": v
        for k, v in sorted(FLASH_PTXAS.items())}
    print(f"  flash_decode: {report['flash_decode_ptxas']}")
    # no instantiation of decode attention (kernel 8) spills
    log = ptxas.get("decode_attention", "")
    DECODE_PTXAS.update(ptxas_by_mode(log, "decode_attention_kernel"))
    check(log == "(cached)" or len(DECODE_PTXAS) == 16,
          f"decode_attention: ptxas reported {len(DECODE_PTXAS)} "
          "instantiations")
    for (g, int8, cap), r in DECODE_PTXAS.items():
        check(" 0 bytes spill stores" in r.get("spills", ""),
              f"decode_attention_kernel<{g}, int8={int8}, softcap={cap}> "
              f"spills: {r}")
    report["decode_attention_ptxas"] = {
        f"g={k[0]} int8={k[1]} softcap={k[2]}": v
        for k, v in sorted(DECODE_PTXAS.items())}
    print(f"  decode_attention: {report['decode_attention_ptxas']}")
    for name, mod, log in (("w8a16", w8a16, A16_PTXAS),
                           ("mix_gemm", mix_gemm, MIX_PTXAS)):
        report[f"{name}_ptxas"] = {f"w4={k[0]} grouped={k[1]}": v
                                   for k, v in log.items()}
        report[f"{name}_clusters"] = {
            f"w4={w4} grouped={g}": mod._clusters(0, w4, g)
            for w4 in (False, True) for g in (False, True)}
        print(f"  {name}: {report[f'{name}_ptxas']}; clusters of 1..8 "
              "blocks the card holds at once "
              f"(cudaOccupancyMaxActiveClusters): "
              f"{report[f'{name}_clusters']}")

    report["flash_decode_clusters"] = {
        f"{name} int8={int8} S={S}": FD._clusters(0, int8, n_q // n_kv, cap,
                                                  S, D)
        for name, (n_q, n_kv, D, cap) in FLASH_SHAPES.items()
        for int8 in (True, False) for S in (128, 640, 4096)}
    print(f"  flash_decode: clusters of 1..8 blocks the card holds at once "
          f"at the served heads: {report['flash_decode_clusters']}")
    from mixq_tpu_torch.kernels import decode_attention as DA
    report["decode_attention_clusters"] = {
        f"{name} int8={int8}": DA._clusters(0, int8, n_q // n_kv, cap, D)
        for name, (n_q, n_kv, D, cap) in DECODE_SHAPES.items()
        for int8 in (True, False)}
    print(f"  decode_attention: clusters of 1..8 blocks the card holds at "
          f"once at the served heads: {report['decode_attention_clusters']}")

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    main_rows = {"rmsnorm_quant": kernel_rmsnorm(dev, gen, rows),
                 "mix_gemm": kernel_mix_gemm(dev, gen, rows),
                 "mix_gemm_w4_grouped": kernel_w4_gemm(dev, gen, rows)}
    main_rows["mix_gemm_a16"], main_rows["w8a16_matmul"] = kernel_a16(
        dev, gen, rows)
    main_rows["int8_matmul_dequant"] = kernel_int8_matmul(dev, gen, rows)
    main_rows["quik_w8a8"], main_rows["quik_w4"] = kernel_quik(dev, rows)
    main_rows["flash_decode"] = kernel_flash(dev, gen, rows)
    main_rows["flash_decode_softcap"] = kernel_flash_softcap(dev, gen, rows)
    main_rows["decode_attention"] = kernel_decode_attention(dev, gen, rows)
    (main_rows["gelu_w8a8"], main_rows["gelu_w4"],
     main_rows["gelu_a16"]) = kernel_gemma2_gemms(dev, gen, rows)
    kernel_flash_small_batch(dev, rows)
    kernel_decode_small_batch(dev, rows)
    (main_rows["flash_decode_alibi"],
     main_rows["decode_attention_alibi"]) = kernel_baichuan(dev, rows)
    (main_rows["flash_decode_pool"],
     main_rows["decode_attention_pool"]) = kernel_pool_rows(dev, rows)
    kernel_eval_shapes(dev, rows)
    (main_rows["rmsnorm_quant_verify"], main_rows["mix_gemm_verify"],
     main_rows["flash_decode_verify"]) = kernel_verify_shapes(dev, rows)
    for name, rs in rows.items():
        for r in rs:
            lib = ("-" if r.get("library_ms") is None
                   else f"{r['library_ms']:.4f}")
            print(f"kernel {name} [{r['work']}]: ms {r['ms']:.4f} "
                  f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
                  f"plain_ms {r['plain_ms']:.4f} library_ms {lib} "
                  f"max_abs_err {r['max_abs_err']:.3g}"
                  + (f" beyond_2_ulps {r['beyond_2_ulps']:.3g} in a share "
                     f"{r['share_beyond_2_ulps']:.3g} of outputs"
                     if "beyond_2_ulps" in r else "")
                  + (f", at most {r['beyond_levels']:.3g} probability levels"
                     " of a row" if "beyond_levels" in r else "")
                  + f" ({r['tolerance']})"
                  + (f" plan {r['plan']}" if "plan" in r else "")
                  + (f" by R {r['ms_by_splits']}" if "ms_by_splits" in r
                     else "")
                  + (f" by plan {r['ms_by_plan']}" if "ms_by_plan" in r
                     else "")
                  + (f" trivial launch {r['trivial_launch_ms']:.4f} ms"
                     if "trivial_launch_ms" in r else "")
                  + (f" earlier kernel {r['previous_ms']:.4f} ms "
                     f"({r['previous_from']}, not measured in this run)"
                     if r.get("previous_ms") else ""),
                  flush=True)
    # the yardstick: kernel 8 at Mistral's int8 heads beside kernel 3 at the
    # same heads and bytes in the head-major layout
    k8, k3 = rows["decode_attention"][0], rows["flash_decode"][2]
    report["kernel8_vs_kernel3"] = dict(kernel8_ms=k8["ms"],
                                        kernel3_ms=k3["ms"],
                                        ratio=k8["ms"] / k3["ms"])
    print(f"yardstick: kernel 8 [{k8['work']}] {k8['ms']:.4f} ms beside "
          f"kernel 3 [{k3['work']}] {k3['ms']:.4f} ms: "
          f"{k8['ms'] / k3['ms']:.3f}x on {card}", flush=True)
    report["kernels"] = rows
    torch.cuda.empty_cache()

    report["phase_s"] = {}
    t_phase = [t_start]

    def phase_done(name):
        """Host seconds of a phase, printed as it ends."""
        now = time.perf_counter()
        report["phase_s"][name] = now - t_phase[0]
        t_phase[0] = now
        print(f"phase {name}: {report['phase_s'][name]:.1f} s", flush=True)

    phase_done("1-3 card, build, kernels")
    report["reference"] = reference_check(dev)
    report["reference"]["cb"] = cb_reference(dev)
    phase_done("4 reference")

    report["paths"] = {}
    for model, name, label, tag, kv_dtype, attn_impl in PATHS:
        cfg, specs = MODELS[model](), path_specs(name, attn_impl)
        if model in SERVE_LAYERS:
            cfg = dataclasses.replace(
                cfg, num_hidden_layers=SERVE_LAYERS[model])
        t0 = time.perf_counter()
        # QUIK's path draws from its own generator: the other phases keep
        # their inputs
        g = (torch.Generator(device=dev).manual_seed(19) if name == "QUIK"
             else gen)
        params = init_decoder_params(cfg, specs, g, device=dev,
                                     dtype=torch.bfloat16,
                                     outlier_budget=INIT_BUDGET.get(name,
                                                                    128))
        torch.cuda.synchronize()
        path = {"init_s": time.perf_counter() - t0,
                "param_gib": tensor_bytes(params) / 2 ** 30}
        print(f"init: {label}, {cfg.num_hidden_layers} layers, "
              f"{path['param_gib']:.2f} GiB of parameters, "
              f"{path['init_s']:.1f} s", flush=True)
        eng, path["serve"] = serve(dev, params, cfg, specs, name, kv_dtype)
        # the f32 head the engine widened once, held for its life
        path["head_f32_gib"] = tensor_bytes(eng.head_f32) / 2 ** 30
        print(f"serve {label}: {path['serve']}", flush=True)
        if label in TIMED_PATHS:
            path["prefill"] = prefill_timing(dev, eng, cfg)
            print(f"prefill {label}: {path['prefill']} on {card}",
                  flush=True)
            path["decode"] = decode_timing(dev, eng, cfg, g, tag, name)
            if name == "QUIK":
                path["decode"]["split"] = quik_step_split(dev, eng, cfg, g)
                print(f"decode split {label}: {path['decode']['split']} on "
                      f"{card}", flush=True)
            if label in PREV_KERNEL8_STEP_MS:
                path["decode"].update(
                    previous_attention_ms_per_step=PREV_KERNEL8_STEP_MS[
                        label], previous_from="171275c")
            decode = {k: ({m: x for m, x in v.items()
                           if m != "top_kernels_us_per_step"}
                          if isinstance(v, dict)
                          and k != "launches_per_step" else v)
                      for k, v in path["decode"].items()}
            print(f"decode {label}: {decode} on {card}", flush=True)
        if cfg.sliding_window is not None and cfg.sliding_window_pattern == 1:
            path["ring_step"] = ring_step(dev, eng, cfg, gen)
            print(f"ring step {label}: {path['ring_step']}", flush=True)
        path["host_s"] = time.perf_counter() - t0
        print(f"path {label}: {path['host_s']:.1f} s", flush=True)
        report["paths"][label] = path
        del eng, params                 # free the model before the next
        gc.collect()
        torch.cuda.empty_cache()
    phase_done("5-6 serve, timing")
    report["pipeline"], warmed, specs = pipeline_phase(dev, gen, report)
    phase_done("7 pipeline")
    # phase 9 serves phase 7's warmed W8A8O16 params as loaded from their
    # checkpoint, then frees them
    report["cb"] = cb_phase(dev, warmed, llama2_7b(), specs)
    del warmed
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("9 continuous batching")
    report["baichuan"] = baichuan_phase(dev, gen)
    phase_done("8 Baichuan")
    report["evaluation"] = eval_phase(dev, card)
    phase_done("10 evaluation")
    report["spec"] = spec_phase(dev)
    phase_done("11 speculative serving")
    report["total_s"] = time.perf_counter() - t_start

    kernels = []
    served = {**report["paths"], **report["baichuan"]["paths"],
              **report["cb"]["pools"], "evaluation": report["evaluation"],
              **report["spec"]["pools"]}
    for name, mod, attr, row, keys, labels in KERNEL_ROWS:
        source = MODULES[mod].SOURCE
        r = main_rows[row]
        runs = [p["serve"] for label, p in served.items()
                if labels is None or label in labels]
        n = sum(r["executed"].get(k, 0) for r in runs
                for k in EXECUTED_AS.get(name, keys))
        calls = sum(r["launches"].get(k, 0) for r in runs for k in keys)
        check(n > 0 and calls > 0, f"{name}: {n} runs on the card and "
              f"{calls} wrapper launches on the main paths")
        kernels.append({
            "name": name, "mode": r["mode"], "route": "cuda",
            "source": source,
            "replaces": getattr(MODULES[mod], attr), "launches": n,
            "wrapper_launches": calls,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "work": r["work"], **({"note": KERNEL_NOTES[name]}
                                  if name in KERNEL_NOTES else {})})
    report["kernels_line"] = kernels
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"total: {report['total_s']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
