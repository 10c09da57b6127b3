"""Text generation on the PyTorch port (mirrors generate.py): a quantized
checkpoint (a directory with manifest.json, written by either package) or
an HF safetensors directory, served by InferenceEngine.

  python generate_torch.py --model_path <dir> --prompt_ids 1,2,3 4,5 \
      [--max_new_tokens 64] [--temperature 0.8 --top_k 40 --top_p 0.95] \
      [--device cpu]
  python generate_torch.py --model_path <dir> --prompt "Hello, my name is"

--prompt_ids takes comma-separated token ids, one prompt each, and prints
one JSON line per prompt ({"prompt_ids", "token_ids"}); --prompt takes
text, which transformers' tokenizer (of --tokenizer_path, default
--model_path) encodes and decodes. Runs on the card unless --device cpu.
"""
import argparse
import json


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--tokenizer_path", default=None,
                    help="defaults to model_path")
    ap.add_argument("--prompt", default=None, nargs="+")
    ap.add_argument("--prompt_ids", default=None, nargs="+",
                    help="comma-separated token ids, one prompt each")
    ap.add_argument("--max_new_tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_seq", type=int, default=2048)
    ap.add_argument("--kv_dtype", default="bfloat16")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if (args.prompt is None) == (args.prompt_ids is None):
        raise SystemExit("give --prompt (text) or --prompt_ids, not both")

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.sampling import SamplingParams
    from mixq_tpu_torch.models.auto import AutoModel

    tok, eos = None, None
    if args.prompt is not None:
        from mixq_tpu_torch.utils.calib_data import load_tokenizer

        tok = load_tokenizer(args.tokenizer_path or args.model_path)
        prompt_ids = [tok(p).input_ids for p in args.prompt]
        eos = tok.eos_token_id
    else:
        prompt_ids = [[int(x) for x in p.split(",")] for p in args.prompt_ids]
    engine = AutoModel.engine(
        args.model_path,
        EngineConfig(max_seq_len=args.max_seq, kv_dtype=args.kv_dtype),
        device=args.device)
    out = engine.generate(
        prompt_ids, max_new_tokens=args.max_new_tokens,
        sampling=SamplingParams(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p),
        seed=args.seed, eos_token_id=eos)
    for i, (ids, o) in enumerate(zip(prompt_ids, out)):
        if tok is None:
            print(json.dumps({"prompt_ids": ids, "token_ids": o}))
        else:
            print(f"=== {args.prompt[i]!r}\n{tok.decode(o)}\n")


if __name__ == "__main__":
    main()
