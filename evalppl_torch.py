"""Perplexity evaluation on the PyTorch port (mirrors evalppl.py):
sliding-window PPL of a token stream through eval.compute_perplexity, per
backend (fp16 / mix8 / mix4, or whatever a quantized checkpoint is), with
a JSON row and optional CSV output.

  python evalppl_torch.py --model_path <hf_dir or quantized_dir> \
      [--eval_tokens wiki.npy | --eval_text wiki.txt] \
      [--model_type fp16|mix8|mix4|quik] [--n_ctx 512] [--batch 8] \
      [--device cpu]

Quantizing at eval time (mix8, mix4, quik on an HF directory) calibrates
on --calib_tokens, never on the eval stream unless --allow_eval_calib says
so.
--eval_text tokenizes with transformers. Runs on the card unless --device
cpu; the row names the device.
"""
import argparse
import csv
import json
import os
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--model_type", default="auto",
                    help="auto|fp16|mix8|mix4|quik (auto = whatever the "
                         "checkpoint is)")
    ap.add_argument("--eval_tokens", default=None, help=".npy token stream")
    ap.add_argument("--eval_text", default=None)
    ap.add_argument("--n_ctx", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max_windows", type=int, default=None)
    ap.add_argument("--kv_dtype", default="bfloat16")
    ap.add_argument("--output_csv", default=None)
    ap.add_argument("--calib_tokens", default=None,
                    help=".npy token stream for 4-bit calibration (never "
                         "the eval set)")
    ap.add_argument("--allow_eval_calib", action="store_true",
                    help="explicitly allow calibrating on the eval tokens "
                         "(leaks eval data into quantization; off by default)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.eval import compute_perplexity
    from mixq_tpu_torch.eval.perplexity import kv_torch_dtype
    from mixq_tpu_torch.models.auto import AutoModel
    from mixq_tpu_torch.utils.calib_data import (blocks_from_tokens,
                                                 load_tokenizer)

    if args.eval_tokens:
        tokens = np.load(args.eval_tokens)
        bos = 1
    elif args.eval_text:
        tok = load_tokenizer(args.model_path)
        with open(args.eval_text, errors="ignore") as f:
            tokens = np.asarray(tok(f.read()).input_ids, np.int32)
        bos = tok.bos_token_id or 1
    else:
        raise SystemExit("need --eval_tokens or --eval_text")

    qcfg = {
        "fp16": None,
        "mix8": QuantConfig.w8a8(),
        "mix4": QuantConfig.w4a4(),
        "quik": QuantConfig.quik_w4a4(),
    }.get(args.model_type, "auto")

    dev = args.device
    if os.path.exists(os.path.join(args.model_path, "manifest.json")):
        params, cfg, specs = AutoModel.from_quantized(args.model_path,
                                                      device=dev)
    elif qcfg == "auto" or qcfg is None:
        params, cfg, specs = AutoModel.from_pretrained(args.model_path,
                                                       device=dev)
    else:
        if args.calib_tokens:
            calib_stream = np.load(args.calib_tokens)
        elif args.allow_eval_calib:
            calib_stream = tokens
        else:
            raise SystemExit(
                "quantizing at eval time needs --calib_tokens <pile.npy>; "
                "calibrating on the eval stream leaks eval data into the "
                "outlier selection (pass --allow_eval_calib to override)")
        calib = blocks_from_tokens(calib_stream, n_samples=16,
                                   block_len=min(512, args.n_ctx))
        params, cfg, specs = AutoModel.from_pretrained(
            args.model_path, quant_config=qcfg, calib_batches=calib,
            device=dev)

    t0 = time.time()
    result = compute_perplexity(
        params, cfg, tokens, specs, n_ctx=args.n_ctx,
        batch_size=args.batch, bos_token_id=bos,
        kv_dtype=kv_torch_dtype(args.kv_dtype), max_windows=args.max_windows)
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0

    row = {
        "model": args.model_path, "backend": args.model_type,
        "ppl": result.ppl, "n_ctx": args.n_ctx,
        "windows": result.n_windows, "tokens": result.n_tokens,
        "seconds": round(dt, 1),
        "windows_per_s": round(result.n_windows / dt, 2),
        "device": (torch.cuda.get_device_name(0)
                   if torch.device(dev).type == "cuda" else "cpu"),
    }
    print(json.dumps(row))
    if args.output_csv:
        os.makedirs(os.path.dirname(args.output_csv) or ".", exist_ok=True)
        exists = os.path.exists(args.output_csv)
        with open(args.output_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if not exists:
                w.writeheader()
            w.writerow(row)


if __name__ == "__main__":
    main()
