"""Continuous-batching serving on the PyTorch port (mirrors
examples/serve_cb.py): drain a JSONL request file through
AutoModel.serving_engine (the slot-pool engine over a checkpoint
directory), emitting completions as they finish.

  python examples/serve_cb_torch.py --model_path <dir> --requests reqs.jsonl
      [--slots 8 --max_seq 2048 --kv_dtype int8 --warmup] [--device cpu]

Request lines: {"prompt_ids": [ints], "max_new_tokens": 64,
                "temperature": 0.8, "top_k": 40, "top_p": 0.95,
                "stop_token_ids": [ints]}
(all fields but prompt_ids optional; sampling fields default to greedy).
A "prompt" of text needs --tokenizer_path, which transformers loads; a
text request without one gets an error record, as in JAX.
Output lines: {"id": N, "token_ids"/"text": ..., "tokens": M,
               "steps_waited": K} (+ "logprobs" with --logprobs)
Runs on the card unless --device cpu.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--tokenizer_path", default=None,
                    help="loads transformers' tokenizer for text prompts")
    ap.add_argument("--requests", required=True,
                    help="JSONL request file ('-' for stdin)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max_seq", type=int, default=2048)
    ap.add_argument("--kv_dtype", default="bfloat16")
    ap.add_argument("--max_new_tokens", type=int, default=64,
                    help="default budget for requests without one")
    ap.add_argument("--eos_token_id", type=int, default=None)
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and capture the window graphs "
                         "first")
    ap.add_argument("--spec_k", type=int, default=0,
                    help=">1: speculative serving (device spec windows: "
                         "greedy rows draft prompt-lookup n-grams on the "
                         "device; the same tokens in fewer forwards)")
    ap.add_argument("--spec_ngram", type=int, default=3)
    ap.add_argument("--logprobs", action="store_true",
                    help="include per-token logprobs in output records")
    ap.add_argument("--out", default="-")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.sampling import SamplingParams
    from mixq_tpu_torch.models.auto import AutoModel

    tok = None
    if args.tokenizer_path:
        from mixq_tpu_torch.utils.calib_data import load_tokenizer

        tok = load_tokenizer(args.tokenizer_path)
    eos = args.eos_token_id
    if eos is None and tok is not None:
        eos = tok.eos_token_id
    eng = AutoModel.serving_engine(
        args.model_path,
        EngineConfig(max_batch_size=args.slots, max_seq_len=args.max_seq,
                     kv_dtype=args.kv_dtype, spec_k=args.spec_k,
                     spec_ngram=args.spec_ngram), device=args.device)
    if args.warmup:
        n = eng.warmup()
        print(f"warmup: {n} programs", file=sys.stderr)

    src = sys.stdin if args.requests == "-" else open(args.requests)
    out = sys.stdout if args.out == "-" else open(args.out, "w")

    submit_step = {}       # rid -> window index at submission
    step = 0

    def drain(block: bool):
        nonlocal step
        while eng.has_work:
            if args.spec_k > 1:
                eng.step_spec_window(eos_token_id=eos)
            else:
                eng.step_window(eos_token_id=eos)
            step += 1
            for rid, r in eng.finished_records().items():
                ids = r["tokens"]
                rec = {"id": rid, "tokens": len(ids),
                       "steps_waited": step - submit_step.pop(rid)}
                if tok is not None:
                    rec["text"] = tok.decode(ids)
                else:
                    rec["token_ids"] = ids
                if args.logprobs:
                    rec["logprobs"] = [round(x, 4) for x in r["logprobs"]]
                print(json.dumps(rec), file=out, flush=True)
            if not block:
                return

    try:
        for line in src:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                if "prompt_ids" in req:
                    ids = req["prompt_ids"]
                elif tok is not None:
                    ids = tok(req["prompt"]).input_ids
                else:
                    raise ValueError("text prompt but no tokenizer loaded "
                                     "(--tokenizer_path); send prompt_ids")
            except (ValueError, KeyError, TypeError) as e:
                # reject the one bad request; in-flight completions go on
                print(json.dumps({"error": f"{type(e).__name__}: {e}",
                                  "request": line[:200]}), file=out,
                      flush=True)
                continue
            sp = None
            if any(k in req for k in ("temperature", "top_k", "top_p")):
                sp = SamplingParams(temperature=req.get("temperature", 0.0),
                                    top_k=req.get("top_k", 0),
                                    top_p=req.get("top_p", 1.0))
            rid = eng.add_request(
                ids, req.get("max_new_tokens", args.max_new_tokens),
                sampling=sp, stop_token_ids=req.get("stop_token_ids"))
            submit_step[rid] = step
            drain(block=False)   # overlap serving with request ingestion
        drain(block=True)
    finally:
        if src is not sys.stdin:
            src.close()
        if out is not sys.stdout:
            out.close()
    stats = eng.stats()
    print(f"served {stats['finished']} requests in {step} windows",
          file=sys.stderr)


if __name__ == "__main__":
    main()
