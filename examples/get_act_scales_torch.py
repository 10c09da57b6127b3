"""Calibration act-scale capture on the PyTorch port (mirrors
examples/get_act_scales.py): the running max of each linear group's input
channels over calibration batches, saved as an .npz that either package
reads (quantize.load_act_scales).

  python examples/get_act_scales_torch.py --model_path <hf_dir> \
      --output act_scales/model.npz [--calib_tokens t.npy|--calib_text f.txt]
      [--device cpu]

Runs on the card unless --device cpu; --calib_text tokenizes with
transformers.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--calib_tokens", default=None)
    ap.add_argument("--calib_text", default=None)
    ap.add_argument("--calib_samples", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    from mixq_tpu_torch.models.auto import AutoModel
    from mixq_tpu_torch.quantize import collect_act_scales, save_act_scales
    from mixq_tpu_torch.utils.calib_data import (get_calib_dataset,
                                                 load_tokenizer)

    params, cfg, specs = AutoModel.from_pretrained(args.model_path,
                                                   device=args.device)
    tokenizer = load_tokenizer(args.model_path) if args.calib_text else None
    batches = get_calib_dataset(
        text_path=args.calib_text, tokenizer=tokenizer,
        tokens_path=args.calib_tokens, n_samples=args.calib_samples,
        vocab_size=cfg.vocab_size)
    scales = collect_act_scales(params, cfg, batches, specs)
    os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
    save_act_scales(scales, args.output)
    print(f"saved {len(scales)} act-scale vectors -> {args.output}")


if __name__ == "__main__":
    main()
