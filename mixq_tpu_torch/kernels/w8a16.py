"""Weight-only (a16) GEMM: bf16 activations times int8 or packed int4
weights dequantized in the kernel (kernel B).

One CUDA kernel, mixq_tpu_torch/csrc/w8a16.cu, replaces two TPU kernels:

- mixq_tpu/ops/pallas/mix_gemm.py::mix_gemm with a bf16 activation (its a16
  modes): w int8 [K, N] or packed uint8 [K/2, N] (halves layout), w_scale
  [N] or grouped [G, N], optional fp outlier term and the silu, gelu or
  gelu_new epilogue. This is
  `mix_gemm_a16`; kernels/mix_gemm.py::mix_gemm hands a bf16 activation to
  it.
- mixq_tpu/ops/pallas/w8a16.py::w8a16_matmul (EETQ's w8_a16_gemm): int8,
  per-channel, no epilogue. `w8a16_matmul` is its thin entry point.

Both compute, in this order,

    wd = bf16(bf16(w) * bf16(w_scale[group of k]))     [K, N]
    y  = x @ wd  with f32 accumulation  (+ x_outlier @ w_outlier in f32)
    y  = epilogue(y)  (fuse: "silu", "gelu", "gelu_new");  cast to out_dtype

The scale is rounded to bf16 before the multiply and the product again
after it; applying the scale in f32 gives a different function.

`mix_gemm_a16` launches the kernel for CUDA tensors and runs `w8a16_plain`,
the same arithmetic in PyTorch ops, for CPU tensors. Besides its total
`launches`, the wrapper counts its launches in `mode_launches` by weight
mode (MODES) and, separately, by epilogue (EPILOGUES): a launch counts once
in each.

The kernel splits K over S blocks (a thread-block cluster) when the output
tiles alone would not fill the card; `plan_a16` chooses S and gives the
split bounds the kernel walks, so the plan can be checked on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.ops.quant import unpack_int4

SOURCE = "mixq_tpu_torch/csrc/w8a16.cu"
REPLACES = "mixq_tpu/ops/pallas/mix_gemm.py:93"          # the a16 branch
REPLACES_W8A16 = "mixq_tpu/ops/pallas/w8a16.py:30"
MODES = ("w8", "w8_grouped", "w4", "w4_grouped")
EPILOGUES = _build.FUSES[1:]              # "silu", "gelu", "gelu_new"
# the kernel's tiling (csrc/w8a16.cu): an output tile, the K-rows of one
# stage of the cp.async ring, the ring's depth
BM, BN, KSTEP, STAGES = 64, 128, 64, 4
MAX_SPLITS = _build.MAX_SPLITS


@functools.lru_cache(maxsize=1024)       # every decode step asks again
def plan_a16(M: int, N: int, K: int, w4: bool, G: int, sm_count: int,
             clusters: Optional[Sequence[int]] = None) -> _build.SplitPlan:
    """Kernel B's launch plan: the output tiles (BM x BN), then K split
    over a cluster by `_build.split_k`'s rule (`clusters[S - 1]`: the
    card's clusters of S blocks at once, `_clusters`). A split
    walks whole stages of the stored rows (K-rows, or packed rows [0, K/2)
    for W4, each holding K-rows p and K/2 + p). Grouped scales (G > 1)
    ride with each stage and do not change the plan. `clusters`, when
    given, is a tuple (the plan is cached)."""
    del G
    srows = KSTEP // 2 if w4 else KSTEP
    rows = K // 2 if w4 else K
    tiles = -(-M // BM) * -(-N // BN)
    S, stages = _build.split_k(tiles, -(-rows // srows), sm_count, clusters)
    bounds = tuple((a * srows, min(b * srows, rows)) for a, b in stages)
    return _build.SplitPlan(BM, BN, S, STAGES, srows, bounds, tiles * S)


def _clusters(index: int, w4: bool, grouped: bool) -> Tuple[int, ...]:
    """The card's clusters of 1..8 blocks of one weight mode at once."""
    return _build.cluster_table("w8a16", "w8a16_max_active_clusters", index,
                                int(w4), int(grouped))


def dequant_weight(w: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """wd = bf16(bf16(w) * bf16(w_scale)) [K, N]: a packed weight unpacked
    first, grouped [G, N] scales repeated over their K/G rows."""
    if w.dtype == torch.uint8:
        w = unpack_int4(w)
    ws = w_scale.reshape(-1, w.shape[1])
    if ws.shape[0] > 1:
        ws = torch.repeat_interleave(ws, w.shape[0] // ws.shape[0], dim=0)
    return w.to(torch.bfloat16) * ws.to(torch.bfloat16)


def w8a16_plain(
    x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
    x_outlier: Optional[torch.Tensor] = None,
    w_outlier: Optional[torch.Tensor] = None, fuse: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """PyTorch version of the kernel, in the JAX order: the bf16-rounded
    weight, then an f32 matmul of the bf16 operands (every product exact in
    f32), the outlier term, the epilogue and the cast."""
    _build.check_fuse(fuse, "mix_gemm_a16")
    wd = dequant_weight(w, w_scale)
    y = torch.matmul(x.to(torch.bfloat16).float(), wd.float())
    if x_outlier is not None and w_outlier is not None:
        y = y + torch.matmul(x_outlier.float(), w_outlier.float())
    return _build.apply_epilogue(y, fuse).to(out_dtype)


@functools.cache
def _launcher():
    fn = _build.load("w8a16").w8a16_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _mode(w4: bool, G: int) -> str:
    return ("w4" if w4 else "w8") + ("_grouped" if G > 1 else "")


def mix_gemm_a16(
    x: torch.Tensor,                          # bf16 [M, K]
    w: torch.Tensor,                          # int8 [K, N] | uint8 [K/2, N]
    w_scale: torch.Tensor,                    # f32 [N] | [G, N]
    x_outlier: Optional[torch.Tensor] = None,  # bf16 [M, B]
    w_outlier: Optional[torch.Tensor] = None,  # bf16 [B, N]
    fuse: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Returns y [M, N] in out_dtype (bf16 or f32)."""
    if x.device.type == "cpu":
        return w8a16_plain(x, w, w_scale, x_outlier, w_outlier, fuse,
                           out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    fuse_code = _build.check_fuse(fuse, "mix_gemm_a16")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    w4 = w.dtype == torch.uint8
    M, K = x.shape
    N = w.shape[1]
    if K % (32 if w4 else 16) or N % 16:
        raise ValueError(f"K ({K}) must be a multiple of {32 if w4 else 16} "
                         f"and N ({N}) of 16")
    dev = x.device
    G = _build.scale_groups(w_scale, K, what="mix_gemm_a16")
    _build.require(x, torch.bfloat16, (M, K), "x", dev)
    _build.require(w, w.dtype if w4 else torch.int8,
                   (K // 2, N) if w4 else (K, N), "w", dev)
    _build.require(w_scale, torch.float32,
                   (G, N) if G > 1 else tuple(w_scale.shape), "w_scale", dev)
    if w_scale.numel() != G * N:
        raise ValueError(f"w_scale {tuple(w_scale.shape)} for N={N}")
    has_out = x_outlier is not None and w_outlier is not None
    Bo = 0
    if has_out:
        Bo = x_outlier.shape[-1]
        if Bo % 16:
            raise ValueError(f"outlier budget {Bo} must be a multiple of 16")
        _build.require(x_outlier, torch.bfloat16, (M, Bo), "x_outlier", dev)
        _build.require(w_outlier, torch.bfloat16, (Bo, N), "w_outlier", dev)
    index = x.get_device()
    plan = plan_a16(M, N, K, w4, G, _build.sm_count(index),
                    _clusters(index, w4, G > 1))
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(
        x.data_ptr(), w.data_ptr(), w_scale.data_ptr(),
        x_outlier.data_ptr() if has_out else None,
        w_outlier.data_ptr() if has_out else None, out.data_ptr(),
        M, N, K, Bo, G, int(w4), fuse_code,
        int(out_dtype == torch.float32), plan.splits, stream)
    _build.check(rc, "mix_gemm_a16")
    mix_gemm_a16.launches += 1
    mix_gemm_a16.mode_launches[_mode(w4, G)] += 1
    if fuse_code:
        mix_gemm_a16.mode_launches[fuse] += 1
    return out


mix_gemm_a16.launches = 0
mix_gemm_a16.mode_launches = dict.fromkeys(MODES + EPILOGUES, 0)


def w8a16_matmul(
    x: torch.Tensor,                # bf16 [M, K]
    q_w: torch.Tensor,              # int8 [K, N]
    w_scale: torch.Tensor,          # f32 [N]
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """mixq_tpu/ops/pallas/w8a16.py::w8a16_matmul's contract (int8 weight,
    per-channel scale, no epilogue) on kernel B."""
    if q_w.dtype != torch.int8 or w_scale.dim() != 1:
        raise ValueError("w8a16_matmul takes an int8 [K, N] weight and a "
                         "[N] scale")
    return mix_gemm_a16(x, q_w, w_scale, out_dtype=out_dtype)
