"""Engine throughput on the PyTorch port (mirrors benchflops.py): decode
tokens/s at a batch sweep of a loaded checkpoint, one JSON row per batch
size (with the card's name) and optional CSV output.

  python benchflops_torch.py --model_path <dir> [--batch_sizes 32,64] \
      [--n_generate 32] [--kv_dtype int8] [--output_csv out.csv] \
      [--device cpu]

Each batch size prefills random prompts, then times chains of n and 2n
eager decode steps (host clock, the card synchronized at each chain's
end) and reports the difference per step. The cache holds the prompt
and all 3n steps (JAX clamps a write past its end; the port raises), so
--max_seq defaults to prompt_len + 3 * n_generate. Runs on the card
unless --device cpu; a CPU row measures the host, not a card.
"""
import argparse
import csv
import json
import os
import time


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--batch_sizes", default="32,64")
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--n_generate", type=int, default=32)
    ap.add_argument("--kv_dtype", default="int8")
    ap.add_argument("--max_seq", type=int, default=None)
    ap.add_argument("--output_csv", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    import numpy as np
    import torch

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.models.auto import AutoModel

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if os.path.exists(os.path.join(args.model_path, "manifest.json")):
        params, cfg, specs = AutoModel.from_quantized(args.model_path,
                                                      device=dev)
    else:
        params, cfg, specs = AutoModel.from_pretrained(args.model_path,
                                                       device=dev)
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    n = args.n_generate
    max_seq = args.max_seq or (args.prompt_len + 3 * n)
    rows = []
    for bs in [int(b) for b in args.batch_sizes.split(",")]:
        engine = InferenceEngine(
            params, cfg, specs,
            EngineConfig(max_seq_len=max_seq, prefill_chunk=args.prompt_len,
                         kv_dtype=args.kv_dtype), device=dev)
        rng = np.random.RandomState(0)
        prompts = rng.randint(1, cfg.vocab_size,
                              (bs, args.prompt_len)).astype(np.int32)
        cache = engine.new_cache(bs, max_seq)
        logits, cache = engine.prefill(torch.from_numpy(prompts), cache)
        nxt = logits.argmax(-1)
        sync()

        def chain(steps, nxt, cache):
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = engine.decode_step(nxt[:, None], cache)
                nxt = logits.argmax(-1)
            sync()
            return time.perf_counter() - t0, nxt, cache

        t1, nxt, cache = chain(n, nxt, cache)
        t2, nxt, cache = chain(2 * n, nxt, cache)
        per_step = max((t2 - t1) / n, 1e-9)
        row = {
            "batch": bs, "decode_ms_per_step": per_step * 1000,
            "tokens_per_s": bs / per_step,
            "kv_dtype": args.kv_dtype, "model": args.model_path,
            "device": device_name,
        }
        rows.append(row)
        print(json.dumps(row))

    if args.output_csv:
        os.makedirs(os.path.dirname(args.output_csv) or ".", exist_ok=True)
        with open(args.output_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)


if __name__ == "__main__":
    main()
