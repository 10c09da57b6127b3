#!/usr/bin/env python3
"""Prefill and GEMM timing of the PyTorch port, for comparing two trees in
one run (one CUDA card).

    python3 time_prefill.py [--package DIR] [--tag NAME] [--kernel1]

Through the public API only, so that DIR may hold another tree of this
repository (its mixq_tpu_torch is then built and imported instead of the
one beside this script; the helpers come from the chip_smoke.py beside it):
  - the int8-activation GEMM (mix_gemm) at a prefill shape: M=512 rows of
    Llama-2-7B's up/gate (4096x11008) with the SiLU epilogue and 128
    outlier channels, in W8A8 (kernel 2; the inputs of chip_smoke.py's
    prefill row) and in kernel A's W4, per-channel and with 128-row scale
    groups, each checked against its plain version and timed as
    chip_smoke.py times its phase-3 rows (CUPTI, rotated weight copies),
    beside torch._int_mm;
  - kernel 2 at decode (M=64, 128 outlier channels): Gemma-2-9B's gate
    (3584x14336) with the gelu_new epilogue, in a fresh process and
    before any other kernel, so that two trees time it in the same order;
  - kernel A at decode (M=64, 128 outlier channels): the blocks of
    chip_smoke.kernel_a_blocks as the decode step runs them, and
    Gemma-2-9B's W4 gate (3584x14336) with the gelu_new epilogue;
  - for each of chip_smoke.py's serve paths, one prefill of 8 prompts x 64
    tokens into a fresh cache (chip_smoke.prefill_timing).
With --kernel1 it times only kernel 1 (fused RMSNorm + quantization) at
chip_smoke.py's phase-3 rows, on the same inputs and beside the same
trivial-launch floor (chip_smoke.kernel_rmsnorm), each held first to the
tree's plain version under chip_smoke.KERNEL1_TOL's limits; through
fused_rmsnorm_quant and rmsnorm_quant_plain only, which every tree since
the port began has.
Prints one JSON object as its last line and writes it to
chiprun_out/time_prefill_<tag>.json.
"""
import argparse
import gc
import json
import os
import subprocess
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", help="a tree of this repository whose "
                    "mixq_tpu_torch to time (default: the one beside this "
                    "script)")
    ap.add_argument("--tag", default="tree", help="names the output file")
    ap.add_argument("--kernel1", action="store_true",
                    help="time kernel 1's phase-3 rows only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_prefill: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs            # from this script's directory

    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import mixq_tpu_torch
    from mixq_tpu_torch.kernels import _build
    from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain
    from mixq_tpu_torch.models.decoder import init_decoder_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.build_all()
    pkg = os.path.dirname(os.path.abspath(mixq_tpu_torch.__file__))
    res = {"card": card, "tag": args.tag, "package": pkg}

    if args.kernel1:
        from mixq_tpu_torch.kernels import rmsnorm_quant as RQ

        floor = cs.trivial_launch_ms(dev)
        # the smoke's generators: its phase-3 one, from which the M=64 rows
        # draw first, and the one of the other rows (kernel_rmsnorm)
        gens = {True: torch.Generator(device=dev).manual_seed(0),
                False: torch.Generator(device=dev).manual_seed(12)}
        res["kernel1"] = []
        for M, H, a_bits in cs.KERNEL1_ROWS:
            ins = cs.kernel1_inputs(dev, gens[M == 64], M, H, a_bits)
            work = f"M={M} H={H}, 128 outlier channels, A{a_bits}"
            ok, dy, dq, ds = cs.kernel1_close(
                RQ.fused_rmsnorm_quant(*ins), RQ.rmsnorm_quant_plain(*ins),
                a_bits, ins[2])
            cs.check(ok, f"kernel 1 {work} disagrees with its plain "
                         f"version: dy {dy} dq {dq} ds {ds}")
            res["kernel1"].append(dict(
                work=work, max_abs_err=dy, q_lsb_err=dq,
                ms=cs.device_ms(lambda: RQ.fused_rmsnorm_quant(*ins), 200),
                trivial_launch_ms=floor))
        for r in res["kernel1"]:
            print(f"kernel 1 {r['work']}: {r['ms']:.4f} ms (trivial launch "
                  f"{r['trivial_launch_ms']:.4f})", flush=True)
        return finish(res, args.tag, cs.OUT_DIR)

    Bo = 128

    def gemm_row(M, K, N, fuse, w4, G, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        ins, lib_w = cs.gemm_inputs(dev, gen, M, K, N, Bo, G, w4)
        mode = ("W4" if w4 else "W8A8") + (f" grouped G={G}" if G > 1
                                            else "")
        got = mix_gemm(*ins, fuse=fuse)
        torch.cuda.synchronize()
        err = cs.check_gemm(got, mix_gemm_plain(*ins, fuse=fuse),
                            f"mix_gemm {mode} {K}x{N} {fuse} at M={M}")
        q_x, _, xs, ws, xo, wo = ins
        epi = cs.lib_epilogue(fuse)
        return cs.timed_gemm(
            lambda w: mix_gemm(q_x, w, xs, ws, xo, wo, fuse=fuse),
            lambda: mix_gemm_plain(*ins, fuse=fuse),
            lambda w: epi(torch._int_mm(q_x, w)), ins[1], lib_w,
            K * N // (2 if w4 else 1), cs.gemm_bound(M, K, N, Bo, G, w4, fuse),
            work=f"{mode} M={M} K={K} N={N} fuse={fuse} B={Bo}",
            tolerance=cs.GEMM_TOL, max_abs_err=err)

    res["kernel2_gemma_gate"] = gemm_row(64, 3584, 14336, "gelu_new", False,
                                         1, 11)
    print(f"kernel 2 Gemma-2-9B gate: {res['kernel2_gemma_gate']['ms']:.4f} "
          "ms", flush=True)
    # kernel 2's row: chip_smoke.py's prefill row (its generator's seed)
    res["kernel2_prefill"] = gemm_row(512, 4096, 11008, "silu", False, 1, 7)
    print(f"kernel 2 prefill: {res['kernel2_prefill']}", flush=True)
    res["kernel_a_prefill"] = [gemm_row(512, 4096, 11008, "silu", True, G, 8)
                               for G in (1, 32)]
    gen = torch.Generator(device=dev).manual_seed(9)
    res["kernel_a_decode"] = [
        cs.gemm_block(dev, gen, 64, Bo, linears, key=key, mode=mode,
                      work=f"{what} at M=64, {Bo} outlier channels each")
        for key, mode, linears, what in cs.kernel_a_blocks()]
    res["kernel_a_decode"].append(
        gemm_row(64, 3584, 14336, "gelu_new", True, 1, 10))
    for r in res["kernel_a_prefill"] + res["kernel_a_decode"]:
        print(f"kernel A {r['work']}: {r['ms']:.4f} ms", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    res["paths"] = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for model, name, label, _, kv_dtype, attn_impl in cs.PATHS:
        cfg, specs = cs.MODELS[model](), cs.path_specs(name, attn_impl)
        params = init_decoder_params(cfg, specs, gen, device=dev,
                                     dtype=torch.bfloat16,
                                     outlier_budget=128)
        eng = cs.new_engine(dev, params, cfg, specs, kv_dtype)
        res["paths"][label] = cs.prefill_timing(dev, eng, cfg)
        print(f"prefill {label}: {res['paths'][label]}", flush=True)
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()

    return finish(res, args.tag, cs.OUT_DIR)


def finish(res, tag, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"time_prefill_{tag}.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
