"""Offline MIX / QUIK quantization on the PyTorch port (mirrors
examples/basic_quant_mix.py): an HF safetensors directory in, a quantized
checkpoint out in the JAX package's layout (either package loads it).

  python examples/basic_quant_mix_torch.py --model_path <hf_dir> \
      --quant_file <out_dir> --w_bit 8 [--a_bit 8] [--outlier_budget 128] \
      [--calib_tokens tokens.npy | --calib_text file.txt] [--device cpu]

MIX (W8A8O16: empty outlier sets that the online predictor fills at
serving warmup; W4A4O16: sets from calibration), QUIK (--version QUIK,
W4A4 with o/down in W8A8, 256 calibrated outlier channels by default;
examples/basic_quant_quik_torch.py) and WEIGHT_ONLY (W8A16). Runs on the
card unless --device cpu; --calib_text tokenizes with transformers.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", required=True, help="HF checkpoint dir")
    ap.add_argument("--quant_file", required=True, help="output dir")
    ap.add_argument("--w_bit", type=int, default=8, choices=(4, 8))
    ap.add_argument("--a_bit", type=int, default=None)
    ap.add_argument("--version", default="MIX", choices=("MIX", "QUIK",
                                                         "WEIGHT_ONLY"))
    ap.add_argument("--outlier_budget", type=int, default=None)
    ap.add_argument("--calib_tokens", default=None, help=".npy token stream")
    ap.add_argument("--calib_text", default=None)
    ap.add_argument("--calib_samples", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.auto import AutoModel
    from mixq_tpu_torch.models.hf import load_hf_config
    from mixq_tpu_torch.quantize import save_checkpoint
    from mixq_tpu_torch.utils.calib_data import (get_calib_dataset,
                                                 load_tokenizer)

    budget = args.outlier_budget or (128 if args.version == "MIX" else 256)
    qcfg = QuantConfig(
        w_bit=args.w_bit, a_bit=args.a_bit or args.w_bit,
        version=args.version, outlier_budget=budget)

    calib = None
    if args.w_bit <= 4 or args.version == "QUIK":
        cfg = load_hf_config(args.model_path)
        tokenizer = (load_tokenizer(args.model_path) if args.calib_text
                     else None)
        calib = get_calib_dataset(
            text_path=args.calib_text, tokenizer=tokenizer,
            tokens_path=args.calib_tokens, n_samples=args.calib_samples,
            vocab_size=cfg.vocab_size)

    params, cfg, specs = AutoModel.from_pretrained(
        args.model_path, quant_config=qcfg, calib_batches=calib,
        device=args.device)
    save_checkpoint(args.quant_file, params, cfg, qcfg)
    print(f"quantized {args.model_path} -> {args.quant_file} "
          f"(W{qcfg.w_bit}A{qcfg.a_bit} {qcfg.version}, "
          f"outlier budget {qcfg.outlier_budget}, on {args.device})")


if __name__ == "__main__":
    main()
