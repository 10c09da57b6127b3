#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mixq_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each of which fails the run (non-zero exit) when it fails:
  1. card: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: the four CUDA kernel libraries from mixq_tpu_torch/csrc, timed;
  3. kernels: each kernel, in each mode the main paths run, at Llama-2-7B
     main-path shapes against its plain PyTorch version on the same inputs,
     with the stated tolerance, then its device time on the card (CUPTI,
     through torch.profiler) beside its bound (bytes over 3.35 TB/s or
     operations over the data-sheet peak, whichever is larger), its plain
     version's and, where one exists, that of one PyTorch call computing
     the same function (`library_ms`): fused RMSNorm + quantization (A8 and
     A4), the int8 GEMM in its W8A8, packed-W4 and grouped modes, the a16
     (weight-only) GEMM with int8 and packed weights, per-channel and
     grouped, with the w8a16_matmul and int8_matmul_dequant entry points,
     and flash decode;
  4. reference: tiny W8A8, W4A4 (per-channel and grouped) and W8A16 models
     on the card against the same models on the CPU (the plain versions),
     teacher-forced logits, bf16 and int8 KV, launch counts by mode;
  5. serve: full-width 32-layer Llama-2-7B in four configurations, one
     after another (each freed before the next is built): W8A8O16, and
     from the reference policy (quantize.resolve_specs) W4A4O16 per-channel,
     W4A4O16 with 128-row scale groups, and W8A16; random weights from a
     seed, 128 outlier channels per MIX linear input, int8 KV, 8 left-padded
     prompts, 32 greedy tokens through InferenceEngine.generate, with every
     kernel's launch count asserted by mode;
  6. timing: for each configuration the decode step at batch 64 with the
     int8 KV cache filled to 512 positions: ms/step, tok/s, peak device
     memory, the step's byte bound from the model's tensors, and over three
     more steps under torch.profiler the device time per step, the device's
     busy share and the top kernels.
It then prints the kernels line (one entry per ported TPU kernel) and,
last, the device line. Details go to chiprun_out/chip_smoke.json. Without a
CUDA card, or without the package beside it, the script exits non-zero and
prints no result.
"""
import gc
import json
import os
import subprocess
import sys
import time

import torch

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, tensor-core ops/s
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
    memsets) in a torch.profiler window, in microseconds."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def device_ms(fn, iters, warmup=2):
    """Mean device time of one call: the durations of everything `iters`
    calls ran on the card (CUPTI, through torch.profiler), over `iters`.
    The host's gaps between kernels are left out, so a small kernel
    launched from Python is timed, not its launch."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = _device_us(prof)
    check(us > 0, "the profiler saw no device time")
    return us / iters / 1e3


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

def kernel_rmsnorm(dev, gen, rows):
    """A8 (the W8A8 paths and o/down) and A4 (q/k/v, up/gate of W4A4)."""
    from mixq_tpu_torch.kernels.rmsnorm_quant import (fused_rmsnorm_quant,
                                                      rmsnorm_quant_plain)
    from mixq_tpu_torch.ops import quant as Q

    M, H, Bo = 64, 4096, 128
    x = (torch.randn(M, H, generator=gen, device=dev) * 3).to(torch.bfloat16)
    gamma = 1 + 0.1 * torch.randn(H, generator=gen, device=dev)
    oset = Q.outlier_set_from_indices(
        torch.randperm(H, generator=gen, device=dev)[:Bo], H, Bo, device=dev)
    out_rows = []
    for a_bits in (8, 4):
        args = (x, gamma, oset.k_mask, 1e-5, a_bits, oset.ind, oset.mask)
        y, q, s, xo = fused_rmsnorm_quant(*args)
        torch.cuda.synchronize()
        yp, qp, sp, xop = rmsnorm_quant_plain(*args)
        dy = (y.float() - yp.float()).abs()
        dq = (q.int() - qp.int()).abs().max().item()
        ds = ((s - sp).abs() / sp).max().item()
        dxo = (xo.float() - xop.float()).abs()
        ok = (bool((dy <= BF16_ULP * yp.float().abs()).all()) and dq <= 1
              and ds <= 1e-5
              and q.abs().max().item() <= 2 ** (a_bits - 1) - 1
              and bool((dxo <= BF16_ULP * xop.float().abs()).all()))
        check(ok, f"rmsnorm_quant a{a_bits} disagrees: dy {dy.max().item()} "
                  f"dq {dq} ds {ds}")
        nbytes = (M * H * 2 + 2 * H * 4 + Bo * 8 + M * H * 3 + M * 4
                  + M * Bo * 2)
        b, by = bound_ms(nbytes, [(8 * M * H, "f32")])
        out_rows.append(dict(
            mode=f"A{a_bits}",
            work=f"M={M} H={H}, {Bo} outlier channels, A{a_bits}",
            tolerance="y within 1 bf16 ulp, q_x within 1 LSB, x_scale "
                      "rtol 1e-5",
            max_abs_err=dy.max().item(), q_lsb_err=dq,
            ms=device_ms(lambda: fused_rmsnorm_quant(*args), 200),
            plain_ms=device_ms(lambda: rmsnorm_quant_plain(*args), 10),
            bound_ms=b, bound_by=by, library_ms=None))
    rows["rmsnorm_quant"] = out_rows
    return out_rows[0]


# the linears of one Llama-2-7B block at decode: (name, K, N, fuse)
BLOCK = [("q", 4096, 4096, "none"), ("k", 4096, 4096, "none"),
         ("v", 4096, 4096, "none"), ("o", 4096, 4096, "none"),
         ("up", 4096, 11008, "none"), ("gate", 4096, 11008, "silu"),
         ("down", 11008, 4096, "none")]
W4_SLOTS = ("q", "k", "v", "up", "gate")        # W4A4 under the policy
GEMM_TOL = "1 bf16 ulp + 1e-4 max|y|"
INT_MM = "torch._int_mm over the int8 weight values (product only)"


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
    library call; the bound is the sum of theirs."""
    row.update(ms=device_ms(kern, 20), plain_ms=device_ms(plain, 3),
               library_ms=device_ms(lib, 20),
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


def gemm_bound(M, K, N, Bo, G=1, w4=False):
    nbytes = (M * K + K * N // (2 if w4 else 1) + M * 4 + G * N * 4
              + M * Bo * 2 + Bo * N * 2 + M * N * 2)
    return bound_ms(nbytes, [(2 * M * N * K, "int8"), (2 * M * N * Bo,
                                                       "bf16")])


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
        out_rows.append(timed_gemm(
            lambda w: mix_gemm(q_x, w, xs, ws, xo, wo, fuse=fuse),
            lambda: mix_gemm_plain(*ins, fuse=fuse),
            lambda w: torch._int_mm(q_x, w), ins[1], lib_w,
            K * N // (2 if w4 else 1), gemm_bound(M, K, N, Bo, G, w4),
            work=f"{mode} M={M} K={K} N={N} fuse={fuse} B={Bo}", mode=mode,
            tolerance=GEMM_TOL, max_abs_err=err, library=INT_MM))
        del ins, lib_w
    return out_rows, errs


def gemm_block(dev, gen, M, Bo, slots, w4, G_of, **row):
    """Kernels 2 and A over the named linears of one block, as the decode
    step runs them (distinct weights, back to back)."""
    from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain

    seq = [gemm_inputs(dev, gen, M, K, N, Bo, G_of(K), w4) + (fuse,)
           for n, K, N, fuse in BLOCK if n in slots]
    bounds = [gemm_bound(M, K, N, Bo, G_of(K), w4)
              for n, K, N, _ in BLOCK if n in slots]
    return block_row(
        lambda: [mix_gemm(*s[0], fuse=s[2]) for s in seq],
        lambda: [mix_gemm_plain(*s[0], fuse=s[2]) for s in seq],
        lambda: [torch._int_mm(s[0][0], s[1]) for s in seq], bounds,
        tolerance=GEMM_TOL, library=INT_MM, **row)


def kernel_mix_gemm(dev, gen, rows):
    """Kernel 2, W8A8: each distinct shape of a block alone, then the block
    of seven linears (~200 MB of weights)."""
    M, Bo = 64, 128
    out_rows, errs = gemm_cases(dev, gen, M, Bo, [
        (K, N, f, False, 1) for K, N, f in
        sorted({(K, N, f) for _, K, N, f in BLOCK})])
    blk = gemm_block(
        dev, gen, M, Bo, [n for n, *_ in BLOCK], False, lambda K: 1,
        mode="W8A8", max_abs_err=max(errs),
        work=f"the 7 linears of one Llama-2-7B block at M={M}, {Bo} "
             "outlier channels each (q,k,v,o 4096x4096; up, gate+SiLU "
             "4096x11008; down 11008x4096)")
    rows["mix_gemm"] = out_rows + [blk]
    return blk


def kernel_w4_gemm(dev, gen, rows):
    """Kernel A: the packed-W4 linears of a W4A4 block (q, k, v, up, gate+
    SiLU), per-channel and with 128-row scale groups, and the grouped W8A8
    o/down of the grouped W4A4 path; each shape alone over rotated weight
    copies, then each block of five as the decode step runs it."""
    M, Bo, gs = 64, 128, 128
    w4_shapes = sorted({(K, N, f) for n, K, N, f in BLOCK if n in W4_SLOTS})
    out_rows, errs = gemm_cases(dev, gen, M, Bo, (
        [(K, N, f, True, 1) for K, N, f in w4_shapes]
        + [(K, N, f, True, K // gs) for K, N, f in w4_shapes]
        + [(K, N, f, False, K // gs) for n, K, N, f in BLOCK
           if n in ("o", "down")]))
    n = len(w4_shapes)
    blocks = [gemm_block(
        dev, gen, M, Bo, W4_SLOTS, True,
        (lambda K: K // gs) if grouped else (lambda K: 1),
        mode="W4" + (f" grouped group_size={gs}" if grouped else ""),
        max_abs_err=max(errs[n:2 * n] if grouped else errs[:n]),
        work=f"the five W4{' grouped' if grouped else ''} linears of one "
             f"Llama-2-7B W4A4 block at M={M}, {Bo} outlier channels each "
             "(q,k,v 4096x4096; up, gate+SiLU 4096x11008)")
        for grouped in (False, True)]
    rows["mix_gemm_w4_grouped"] = out_rows + blocks
    return blocks[0]


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


def a16_bound(M, K, N, G, w4):
    nbytes = M * K * 2 + K * N // (2 if w4 else 1) + G * N * 4 + M * N * 2
    return bound_ms(nbytes, [(2 * M * N * K, "bf16")])


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
    out_rows, errs = [], []
    for K, N, fuse, w4, G in cases:
        ins, wd = a16_inputs(dev, gen, M, K, N, G, w4)
        mode = ("W4A16" if w4 else "W8A16") + (f" grouped G={G}" if G > 1
                                                else "")
        got = mix_gemm_a16(*ins, fuse=fuse)
        torch.cuda.synchronize()
        err = check_a16(got, w8a16_plain(*ins, fuse=fuse), ins[0], wd,
                        f"mix_gemm_a16 {mode} {K}x{N} {fuse}")
        if not w4 and G == 1:
            errs.append(err)
        x, _, ws = ins
        out_rows.append(timed_gemm(
            lambda w: mix_gemm_a16(x, w, ws, fuse=fuse),
            lambda: w8a16_plain(*ins, fuse=fuse),
            lambda w: torch.matmul(x, w), ins[1], wd,
            K * N // (2 if w4 else 1), a16_bound(M, K, N, G, w4),
            work=f"{mode} M={M} K={K} N={N} fuse={fuse}", mode=mode,
            tolerance=A16_TOL, max_abs_err=err, library=A16_LIB))
        del ins, wd
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
        library=A16_LIB)
    del seq
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
        tolerance=A16_TOL, max_abs_err=err, library=A16_LIB)
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
        tolerance=GEMM_TOL, max_abs_err=err, library=INT_MM)
    rows["int8_matmul_dequant"] = [row]
    return row


def flash_case(dev, gen, B, S, n_q, n_kv, D, int8):
    from mixq_tpu_torch.ops import quant as Q

    q = torch.randn(B, n_q, D, generator=gen, device=dev).to(torch.bfloat16)
    shape = (1, n_kv, B, S, D)
    if int8:
        k, ks = Q.quantize_kv(torch.randn(shape, generator=gen, device=dev))
        v, vs = Q.quantize_kv(torch.randn(shape, generator=gen, device=dev))
    else:
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        ks = vs = None
    lengths = torch.randint(S // 2, S + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    lengths[0], lengths[1] = S, 1
    starts = torch.randint(0, 32, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    starts = torch.minimum(starts, lengths - 1)
    return q, k, v, ks, vs, lengths, starts


def kernel_flash(dev, gen, rows):
    from mixq_tpu_torch.kernels.flash_decode import (flash_decode_attention,
                                                     flash_decode_plain)
    import torch.nn.functional as F

    B, S, D = 64, 512, 128
    main = None
    out_rows = []
    for n_q, n_kv, int8 in ((32, 32, True), (32, 32, False), (32, 8, True)):
        q, k, v, ks, vs, lengths, starts = flash_case(dev, gen, B, S, n_q,
                                                      n_kv, D, int8)
        args = (q, k, v, lengths, ks, vs, starts, 0)
        got = flash_decode_attention(*args)
        torch.cuda.synchronize()
        ref = flash_decode_plain(*args)
        err = (got.float() - ref.float()).abs()
        over = err - 2 * BF16_ULP * ref.float().abs()
        beyond, share = over.max().item(), (over > 0).float().mean().item()
        atol = FLASH_ATOL["int8" if int8 else "bf16"]
        check(beyond <= atol and bool(torch.isfinite(got).all()),
              f"flash_decode n_q={n_q} n_kv={n_kv} int8={int8}: error "
              f"{beyond} beyond two bf16 ulps > {atol}")
        valid = (lengths - starts).sum().item()
        esize = 1 if int8 else 2
        nbytes = (valid * n_kv * D * esize * 2 + (valid * n_kv * 8 if int8
                                                  else 0)
                  + 2 * B * n_q * D * 2 + 8 * B)
        b, by = bound_ms(nbytes, [(4 * valid * n_q * D,
                                   "int8" if int8 else "bf16")])
        lib = None
        if not int8:
            # SDPA over the same bf16 cache, batch-major, with the same mask
            kb = k[0].permute(1, 0, 2, 3).contiguous()
            vb = v[0].permute(1, 0, 2, 3).contiguous()
            pos = torch.arange(S, device=dev)
            mask = ((pos[None] < lengths[:, None])
                    & (pos[None] >= starts[:, None]))[:, None, None, :]
            qb = q[:, :, None, :]
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                qb, kb, vb, attn_mask=mask), 20)
        row = dict(mode=f"{'int8' if int8 else 'bf16'} KV",
                   work=f"B={B} S={S} n_q={n_q} n_kv={n_kv} D={D} "
                        f"{'int8' if int8 else 'bf16'} KV, ragged lengths "
                        f"and kv_start ({valid} valid rows)",
                   tolerance=f"2 bf16 ulps of |y| + {atol}",
                   max_abs_err=err.max().item(), beyond_2_ulps=beyond,
                   share_beyond_2_ulps=share,
                   ms=device_ms(lambda: flash_decode_attention(*args), 50),
                   plain_ms=device_ms(lambda: flash_decode_plain(*args), 5),
                   library_ms=lib,
                   library=(None if int8 else
                            "F.scaled_dot_product_attention, bf16"),
                   bound_ms=b, bound_by=by)
        out_rows.append(row)
        if main is None:
            main = row
        del q, k, v, ks, vs
    rows["flash_decode"] = out_rows
    return main


# ---------------------------------------------------------------------------
# Phases 4-6
# ---------------------------------------------------------------------------

def llama2_7b():
    from mixq_tpu_torch.config import ModelConfig

    # bench.py:54-65 (Llama-2-7B); all 32 layers
    return ModelConfig(model_type="llama", vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=4096)


# launches per layer and forward of each configuration's linears, by mode
# (kernels.launch_counts keys); flash_decode adds one per layer and decode
# step, and every other count stays 0
PER_LAYER = {
    "W8A8": {"rmsnorm_quant": 2, "mix_gemm": 7, "mix_gemm.w8a8": 7},
    "W4A4": {"rmsnorm_quant": 2, "mix_gemm": 7, "mix_gemm.w4": 5,
             "mix_gemm.w8a8": 2},
    "W4A4 grouped": {"rmsnorm_quant": 2, "mix_gemm": 7,
                     "mix_gemm.w4_grouped": 5, "mix_gemm.w8a8_grouped": 2},
    "W8A16": {"w8a16": 7, "w8a16.w8": 7},
}


def path_specs(name, group_size=128, outlier_budget=128):
    """The DecoderSpecs of a configuration: W8A8 on every linear, or the
    reference policy of quantize.resolve_specs (W4A4: q/k/v/up/gate W4A4,
    o/down W8A8; W8A16: weight-only everywhere)."""
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.decoder import DecoderSpecs
    from mixq_tpu_torch.ops.mixed_linear import LinearSpec
    from mixq_tpu_torch.quantize import resolve_specs

    if name == "W8A8":
        return DecoderSpecs.uniform(LinearSpec(w_bit=8, a_bit=8))
    if name == "W8A16":
        return resolve_specs(QuantConfig.w8a16())
    return resolve_specs(QuantConfig.w4a4(
        outlier_budget=outlier_budget,
        q_group_size=group_size if name == "W4A4 grouped" else -1))


def expect_launches(name, L, forwards, decode_steps):
    want = {k: v * L * forwards for k, v in PER_LAYER[name].items()}
    want["flash_decode"] = L * decode_steps
    return want


def check_launches(counts, want, what):
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{what}: launch counts {got} != {want}")


# tiny model card vs CPU: max |dlogits| over max |logits|. W8A8 and W8A16:
# one bf16 rounding that another summation order flips moves an int8
# level or a bf16 ulp (JAX's own jit and eager forwards differ by <= 1.5e-2
# on the tiny W8A8 models). W4A4: a 4-bit activation level is 1/7 of the
# row's absmax, so the same flip moves the logits 18x as far; JAX's own two
# paths differ by up to 8.5e-2 on the tiny W4A4 models
# (tests/test_torch_decoder.py::test_w4a4_limit_is_jax_own_spread).
TINY_TOL = {"W8A8": 2e-2, "W4A4": 1e-1, "W4A4 grouped": 1e-1,
            "W8A16": 2e-2}


def reference_check(dev):
    """Tiny models (seeded outliers on every MIX linear input) on the card
    through the kernels against the same models on the CPU through their
    plain versions, bf16 and int8 KV: teacher-forced logits (a prefill and
    4 decode steps) within TINY_TOL * max|logits|, and every launch count by
    mode. W8A8, W4A4 per-channel and with 64-row groups (a divisor of the
    tiny K/2 = 128 and 256), and W8A16. Every configuration runs before the
    checks, so a failing one still shows the others' numbers."""
    from mixq_tpu_torch.config import EngineConfig, ModelConfig
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.models.decoder import init_decoder_params

    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2)
    toks = torch.randint(1, cfg.vocab_size, (3, 12),
                         generator=torch.Generator().manual_seed(1))
    kv_start = torch.tensor([0, 2, 5], dtype=torch.int32)
    L = cfg.num_hidden_layers
    res, failures = {}, []
    for name in PER_LAYER:
        specs = path_specs(name, group_size=64, outlier_budget=16)
        cpu = init_decoder_params(cfg, specs, torch.Generator().manual_seed(0),
                                  device="cpu", outlier_budget=16)
        for kv_dtype in ("bfloat16", "int8"):
            ecfg = EngineConfig(max_seq_len=64, prefill_chunk=8,
                                kv_dtype=kv_dtype)
            reset_launch_counts()
            outs = []
            for params, d in ((cpu, "cpu"), (params_to(cpu, dev), dev)):
                eng = InferenceEngine(params, cfg, specs, ecfg, device=d)
                cache = eng.new_cache(3, 128)
                logits, cache = eng.prefill(toks[:, :8], cache, kv_start)
                steps = [logits.float().cpu()]
                for i in range(4):
                    logits, cache = eng.decode_step(toks[:, 8 + i:9 + i],
                                                    cache, kv_start)
                    steps.append(logits.float().cpu())
                outs.append(torch.stack(steps))
            ref, got = outs
            err = (got - ref).abs().max().item()
            tol = TINY_TOL[name] * ref.abs().max().item()
            counts = launch_counts()
            want = expect_launches(name, L, 5, 4)
            if not (bool(torch.isfinite(got).all()) and err <= tol):
                failures.append(f"tiny {name} model card vs CPU, {kv_dtype} "
                                f"KV: max |dlogits| {err} > {tol}")
            if {k: v for k, v in counts.items() if v} != want:
                failures.append(f"tiny {name}, {kv_dtype} KV: launches "
                                f"{counts} != {want}")
            res[f"{name} {kv_dtype} KV"] = dict(
                max_abs_err=err, tolerance=tol, shape=list(got.shape))
    print(f"reference: tiny models card vs CPU, teacher-forced logits {res}",
          flush=True)
    check(not failures, "; ".join(failures))
    return res


def serve(dev, params, cfg, specs, name):
    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts

    eng = InferenceEngine(params, cfg, specs, EngineConfig(
        max_seq_len=2048, prefill_chunk=16, kv_dtype="int8"), device=dev)
    g = torch.Generator().manual_seed(2)
    lens = [5, 9, 13, 17, 21, 26, 30, 37]
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    new = 32
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    shape = (len(out), min(len(r) for r in out), max(len(r) for r in out))
    check(shape == (8, new, new), f"{name} generate returned shape {shape}")
    check(all(0 <= t < cfg.vocab_size for r in out for t in r),
          f"{name}: token out of range")
    # one prefill + (new - 1) decode steps
    check_launches(counts, expect_launches(name, cfg.num_hidden_layers, new,
                                           new - 1), f"{name} serve")
    return eng, dict(prompts=lens, new_tokens=new, tokens_shape=[8, new],
                     wall_s=wall, launches=counts, first_row=out[0][:8])


def tensor_bytes(obj):
    """Bytes of every tensor in a parameter container (NamedTuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(tensor_bytes(x) for x in obj)
    return 0


def decode_timing(dev, eng, cfg, gen, tag):
    B, fill, steps, warm = 64, 512, 8, 2
    cache = eng.new_cache(B, 640)
    for buf in (cache.k, cache.v):
        buf.random_(-127, 128, generator=gen)
    for buf in (cache.k_scale, cache.v_scale):
        buf.uniform_(0.005, 0.02, generator=gen)
    cache.length = fill
    kv_start = torch.zeros(B, dtype=torch.int32, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()

    def step(tok):
        logits, _ = eng.decode_step(tok, cache, kv_start)
        return logits, torch.argmax(logits, dim=-1)[:, None].to(torch.int32)

    for _ in range(warm):
        logits, tok = step(tok)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(steps):
        logits, tok = step(tok)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    # least time of a step: every weight read once (of an untied embedding
    # only the B gathered rows), and the valid K/V rows with their f32
    # scales at the mean length of the timed steps
    p = eng.params
    kv_len = fill + warm + (steps + 1) / 2
    unread = (0 if p.lm_head is None else tensor_bytes(p.embed)
              - B * cfg.hidden_size * p.embed.element_size())
    nbytes = (tensor_bytes(p) - unread + 2 * cfg.num_hidden_layers
              * cfg.num_key_value_heads * B * kv_len * (cfg.head_dim_ + 4))
    check(tuple(logits.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "decode logits not finite")
    res = dict(batch=B, kv_filled=fill, steps=steps,
               ms_per_step=wall * 1e3,
               event_ms_per_step=e0.elapsed_time(e1) / steps,
               tok_per_s=B / wall,
               bound_ms=bound_ms(nbytes, [])[0],
               max_memory_allocated_gib=torch.cuda.max_memory_allocated()
               / 2 ** 30)
    res.update(profile_steps(step, tok, tag))
    return res


def profile_steps(step, tok, tag, n=3):
    """Device time per step, the device's busy share and the top kernels
    over n decode steps; the profiler's table goes to
    chiprun_out/profile_<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            _, tok = step(tok)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType

    ka = prof.key_averages()
    dev_us = _device_us(prof)
    top = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:15]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40))
    return dict(profiled_steps=n, profiled_wall_us=wall_us, device_us=dev_us,
                device_ms_per_step=dev_us / n / 1e3,
                device_busy_share=dev_us / wall_us,
                top_kernels_us_per_step=[
                    (e.key[:60], e.count, e.self_device_time_total / n)
                    for e in top])


# the kernels line: one entry per ported TPU kernel (a row of PERF.md's
# table): (name, source module, REPLACES attribute, phase-3 row key,
# launch-count keys summed over the four serve runs)
KERNEL_ROWS = [
    ("rmsnorm_quant", "rmsnorm_quant", "REPLACES", "rmsnorm_quant",
     ("rmsnorm_quant",)),
    ("mix_gemm_w8a8", "mix_gemm", "REPLACES", "mix_gemm",
     ("mix_gemm.w8a8",)),
    ("mix_gemm_w4_grouped", "mix_gemm", "REPLACES_W4", "mix_gemm_w4_grouped",
     ("mix_gemm.w4", "mix_gemm.w4_grouped", "mix_gemm.w8a8_grouped")),
    ("mix_gemm_a16", "w8a16", "REPLACES", "mix_gemm_a16", ("w8a16",)),
    ("w8a16_matmul", "w8a16", "REPLACES_W8A16", "w8a16_matmul",
     ("w8a16.w8",)),
    ("int8_matmul_dequant", "mix_gemm", "REPLACES_INT8_MATMUL",
     "int8_matmul_dequant", ("mix_gemm.w8a8",)),
    ("flash_decode", "flash_decode", "REPLACES", "flash_decode",
     ("flash_decode",)),
]
KERNEL_NOTES = {
    "w8a16_matmul": "launches: the a16 kernel's int8 per-channel mode, "
                    "which computes this entry's function",
    "int8_matmul_dequant": "launches: kernel 2's W8A8 mode, which computes "
                           "this entry's function",
}


def main():
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

    t0 = time.perf_counter()
    ptxas = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s for {len(ptxas)} kernel "
          "libraries", flush=True)
    for name, log in ptxas.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(sorted(set(regs)))[:400])

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    main_rows = {"rmsnorm_quant": kernel_rmsnorm(dev, gen, rows),
                 "mix_gemm": kernel_mix_gemm(dev, gen, rows),
                 "mix_gemm_w4_grouped": kernel_w4_gemm(dev, gen, rows)}
    main_rows["mix_gemm_a16"], main_rows["w8a16_matmul"] = kernel_a16(
        dev, gen, rows)
    main_rows["int8_matmul_dequant"] = kernel_int8_matmul(dev, gen, rows)
    main_rows["flash_decode"] = kernel_flash(dev, gen, rows)
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
                  + f" ({r['tolerance']})",
                  flush=True)
    report["kernels"] = rows
    torch.cuda.empty_cache()

    report["reference"] = reference_check(dev)

    cfg = llama2_7b()
    report["paths"] = {}
    launches = {}
    for name, label in (("W8A8", "W8A8O16"), ("W4A4", "W4A4O16"),
                        ("W4A4 grouped", "W4A4O16 group_size=128"),
                        ("W8A16", "W8A16")):
        specs = path_specs(name)
        t0 = time.perf_counter()
        params = init_decoder_params(cfg, specs, gen, device=dev,
                                     dtype=torch.bfloat16,
                                     outlier_budget=128)
        torch.cuda.synchronize()
        path = {"init_s": time.perf_counter() - t0}
        print(f"init: Llama-2-7B {label}, {cfg.num_hidden_layers} layers, "
              f"{tensor_bytes(params) / 2 ** 30:.2f} GiB of parameters, "
              f"{path['init_s']:.1f} s", flush=True)
        eng, path["serve"] = serve(dev, params, cfg, specs, name)
        print(f"serve {label}: {path['serve']}", flush=True)
        tag = label.split()[0] + ("_g128" if "group" in label else "")
        path["decode"] = decode_timing(dev, eng, cfg, gen, tag)
        decode = {k: v for k, v in path["decode"].items()
                  if k != "top_kernels_us_per_step"}
        print(f"decode {label}: {decode} on {card}", flush=True)
        report["paths"][label] = path
        for k, v in path["serve"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        del eng, params                 # free the model before the next
        gc.collect()
        torch.cuda.empty_cache()
    report["total_s"] = time.perf_counter() - t_start

    kernels = []
    for name, mod, attr, row, keys in KERNEL_ROWS:
        r = main_rows[row]
        n = sum(launches[k] for k in keys)
        check(n > 0, f"{name}: no launch on the main paths")
        kernels.append({
            "name": name, "mode": r["mode"], "route": "cuda",
            "source": MODULES[mod].SOURCE,
            "replaces": getattr(MODULES[mod], attr), "launches": n,
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
