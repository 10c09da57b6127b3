"""QUIK W4A4 quantization on the PyTorch port (mirrors
examples/basic_quant_quik.py): basic_quant_mix_torch.py with --version QUIK
and --w_bit 4 unless given, so 256 calibrated fp outlier channels per
linear, asymmetric activations, and o/down in W8A8.

  python examples/basic_quant_quik_torch.py --model_path <hf_dir> \
      --quant_file <out_dir> [--calib_tokens tokens.npy] [--device cpu]

Runs on the card unless --device cpu.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from basic_quant_mix_torch import main, parser  # noqa: E402,F401


def quik_argv(argv):
    argv = list(sys.argv[1:] if argv is None else argv) + ["--version",
                                                           "QUIK"]
    if "--w_bit" not in argv:
        argv += ["--w_bit", "4"]
    return argv


if __name__ == "__main__":
    main(quik_argv(None))
