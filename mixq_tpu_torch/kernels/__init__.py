"""The port's hand-written CUDA kernels, one module per CUDA source.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
module's plain PyTorch version only for CPU tensors. Each keeps a plain
integer count of its launches in its `launches` attribute, and a wrapper
with several modes also counts them by mode in `mode_launches` (the GEMMs
by weight mode and by epilogue, flash decode its softcap launches, decode
attention its KV type, ring and softcap launches), so a run can show that the main path went through the kernels, in the modes it
expects.
"""
from mixq_tpu_torch.kernels import (decode_attention, flash_decode, mix_gemm,
                                    rmsnorm_quant, w8a16)

# name -> the kernel's module (wrapper, plain version, SOURCE, REPLACES)
MODULES = {
    "rmsnorm_quant": rmsnorm_quant,
    "mix_gemm": mix_gemm,
    "w8a16": w8a16,
    "flash_decode": flash_decode,
    "decode_attention": decode_attention,
}
WRAPPERS = {
    "rmsnorm_quant": rmsnorm_quant.fused_rmsnorm_quant,
    "mix_gemm": mix_gemm.mix_gemm,
    "w8a16": w8a16.mix_gemm_a16,
    "flash_decode": flash_decode.flash_decode_attention,
    "decode_attention": decode_attention.decode_attention,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
        modes = getattr(fn, "mode_launches", None)
        if modes is not None:
            for mode in modes:
                modes[mode] = 0


def launch_counts() -> dict:
    """{kernel: launches} and, for a kernel with modes, {"kernel.mode":
    launches} for each mode."""
    out = {}
    for name, fn in WRAPPERS.items():
        out[name] = fn.launches
        for mode, n in getattr(fn, "mode_launches", {}).items():
            out[f"{name}.{mode}"] = n
    return out
