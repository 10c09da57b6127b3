"""Int8-activation mixed-precision GEMM with the fused dequant/outlier/SiLU
epilogue (kernel 2 and kernel A).

Replaces mixq_tpu/ops/pallas/mix_gemm.py::mix_gemm in its int8-activation
modes with one CUDA kernel, mixq_tpu_torch/csrc/mix_gemm.cu, a template
over <W4, GROUPED> whose instantiation is chosen as JAX chooses the mode,
from dtypes and shapes:

    w int8 [K, N]           W8
    w uint8 [K/2, N]        packed W4, halves layout ("w4")
    w_scale [N]             per-channel: y = float(q_x @ w) * x_scale * w_scale
    w_scale [G, N], G > 1   grouped: y = (sum_g float(acc_g) * w_scale[g])
                            * x_scale ("w8a8_grouped", "w4_grouped")
    x_zero [M, 1], reduced_w [N]
                            QUIK's zero point (per-channel W8 or W4 only):
                            y = (x_scale * w_scale) * (float(acc)
                            + x_zero * reduced_w) ("w8a8_zp", "w4_zp")
    (+ x_outlier @ w_outlier in f32); the epilogue `fuse` ("silu", "gelu",
    "gelu_new"; _build.apply_epilogue); cast to out_dtype

W8 per-channel ("w8a8") is kernel 2, the other three modes kernel A; the
zero-point modes ("w8a8_zp", "w4_zp") are the per-channel W8 and W4
kernels with the term compiled in (mix_gemm_zp_kernel<W4> in the source).
The kernel splits K over a thread-block cluster when the output tiles
alone would not fill the card, and `plan_mix` chooses the split and gives
the bounds the kernel walks, so the plan can be checked on the CPU.

`mix_gemm_experts` is kernel 2 over the E experts of an MoE linear in one
launch ("w8a8_experts"): q_x int8 [E, C, K], w int8 [E, K, N], x_scale f32
[E, C, 1] and w_scale f32 [E, N] give y [E, C, N] f32 = float(q_x[e] @
w[e]) * x_scale[e] * w_scale[e] (mixq_tpu/ops/moe.py::expert_linear's W8A8
product, a jnp dot_general in JAX), with no outlier term or epilogue; its
plan counts the E x tiles output tiles.

A bf16 activation is the a16 (weight-only) mode, which runs on kernel B
(kernels/w8a16.py); `mix_gemm` hands it over, as the Pallas kernel
dispatches on the activation's dtype. `int8_matmul_dequant` is
mixq_tpu/ops/pallas/int8_matmul.py's entry point, the W8A8 contract, as a
thin call onto this kernel.

`mix_gemm` launches the kernel for CUDA tensors and runs `mix_gemm_plain`,
the same arithmetic in PyTorch ops, for CPU tensors. Besides its total
`launches`, the wrapper counts its launches in `mode_launches` by weight
mode (MODES) and, separately, by epilogue (EPILOGUES): a launch counts once
in each.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.kernels.w8a16 import mix_gemm_a16
from mixq_tpu_torch.ops.quant import grouped_int8_matmul_dequant, unpack_int4

SOURCE = "mixq_tpu_torch/csrc/mix_gemm.cu"          # kernels 2 and A
REPLACES = "mixq_tpu/ops/pallas/mix_gemm.py:140"
REPLACES_W4 = "mixq_tpu/ops/pallas/mix_gemm.py:43"     # _unpack_w4, grouped
REPLACES_INT8_MATMUL = "mixq_tpu/ops/pallas/int8_matmul.py:53"
# QUIK's GEMM has no Pallas kernel: JAX runs its int8 dot_general and the
# zero-point epilogue in jnp (quik_linear)
REPLACES_QUIK = "mixq_tpu/ops/mixed_linear.py:341"
# nor has MoE's expert GEMM: JAX's expert_linear is one int8 batched
# dot_general
REPLACES_EXPERTS = "mixq_tpu/ops/moe.py:69"
MODES = ("w8a8", "w8a8_grouped", "w4", "w4_grouped", "w8a8_zp", "w4_zp",
         "w8a8_experts")
EPILOGUES = _build.FUSES[1:]              # "silu", "gelu", "gelu_new"
# the kernel's tiling (csrc/mix_gemm.cu): an output tile, the stored weight
# rows of one stage of the cp.async ring (W4: packed rows), the ring's
# depth, the blocks an SM holds
BM, BN, KSTEP, STAGES, BLOCKS_PER_SM = 64, 128, 128, 4, 1


@functools.lru_cache(maxsize=1024)       # every decode step asks again
def plan_mix(M: int, N: int, K: int, w4: bool, G: int, sm_count: int,
             clusters: Optional[Sequence[int]] = None,
             experts: int = 1) -> _build.SplitPlan:
    """The kernel's launch plan: the output tiles (BM x BN; the expert
    mode's `experts` x that, M being one expert's rows), then K split
    over a cluster by `_build.split_k`'s rule (`clusters[S - 1]`: the
    card's clusters of S blocks at once, `_clusters`). A split walks whole
    stages of KSTEP stored rows (K-rows, or for W4 packed rows of [0, K/2),
    each holding K-rows p and K/2 + p, so a split covers both halves).
    Per-channel, the splits' int32 partials add exactly and the result
    does not depend on the plan. Grouped (G > 1), K is split in units of
    lcm(KSTEP, K/G) stored rows, so every split bound is a group boundary
    and no group's int32 sum is cut in two; for W4 with a group size that
    does not divide K/2, only in the low half (a high K-row's group is cut
    where it straddles a bound, each part folded with that group's
    scales). `clusters`, when given, is a tuple (the plan is cached)."""
    rows = K // 2 if w4 else K
    unit = KSTEP
    if G > 1:
        gs = K // G
        unit = KSTEP * gs // math.gcd(KSTEP, gs)
    tiles = experts * -(-M // BM) * -(-N // BN)
    S, units = _build.split_k(tiles, -(-rows // unit), sm_count, clusters,
                              BLOCKS_PER_SM)
    bounds = tuple((a * unit, min(b * unit, rows)) for a, b in units)
    return _build.SplitPlan(BM, BN, S, STAGES, KSTEP, bounds, tiles * S)


def _clusters(index: int, w4: bool, grouped: bool,
              zp: bool = False, experts: bool = False) -> Tuple[int, ...]:
    """The card's clusters of 1..8 blocks of one weight mode at once (the
    zero-point modes and the expert mode are kernels of their own)."""
    if experts:
        return _build.cluster_table("mix_gemm",
                                    "mix_gemm_experts_max_active_clusters",
                                    index)
    if zp:
        return _build.cluster_table("mix_gemm",
                                    "mix_gemm_zp_max_active_clusters",
                                    index, int(w4))
    return _build.cluster_table("mix_gemm", "mix_gemm_max_active_clusters",
                                index, int(w4), int(grouped))


def _mode(w4: bool, G: int, zp: bool = False) -> str:
    return (("w4" if w4 else "w8a8") + ("_grouped" if G > 1 else "")
            + ("_zp" if zp else ""))


def _zero_point(x_zero, reduced_w, grouped: bool) -> bool:
    """Whether a call is in a zero-point mode; both operands or neither,
    and per-channel scales only (JAX refuses QUIK with groups)."""
    if (x_zero is None) != (reduced_w is None):
        raise ValueError("the zero point needs both x_zero and reduced_w")
    if x_zero is not None and grouped:
        raise ValueError("a zero point with grouped [G, N] weight scales: "
                         "QUIK takes per-channel scales only")
    return x_zero is not None


def mix_gemm_plain(
    q_x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
    w_scale: torch.Tensor, x_outlier: Optional[torch.Tensor] = None,
    w_outlier: Optional[torch.Tensor] = None, fuse: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
    x_zero: Optional[torch.Tensor] = None,
    reduced_w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PyTorch version of the kernel, in the JAX order of operations. A
    packed weight is unpacked first. The int32 accumulator (per group when
    grouped) is computed in float64, which holds every partial sum of int8
    products exactly (|acc| <= 128*127*K < 2**53), and is rounded to f32 as
    JAX's int32 -> f32 cast rounds it. With a zero point (QUIK,
    mixq_tpu/ops/mixed_linear.py::quik_linear) the scales multiply first,
    then the sum of the accumulator and x_zero * reduced_w, each step
    rounded to f32 on its own."""
    _build.check_fuse(fuse, "mix_gemm")
    grouped = w_scale.dim() == 2 and w_scale.shape[0] > 1
    zp = _zero_point(x_zero, reduced_w, grouped)
    if w.dtype == torch.uint8:
        w = unpack_int4(w)
    if grouped:
        y = grouped_int8_matmul_dequant(q_x, x_scale.reshape(-1, 1), w,
                                        w_scale)
    elif zp:
        acc = torch.matmul(q_x.double(), w.double()).float()
        corr = x_zero.reshape(-1, 1) * reduced_w.reshape(1, -1)
        y = (x_scale.reshape(-1, 1) * w_scale.reshape(1, -1)) * (acc + corr)
    else:
        acc = torch.matmul(q_x.double(), w.double()).float()
        y = acc * x_scale.reshape(-1, 1) * w_scale.reshape(1, -1)
    if x_outlier is not None and w_outlier is not None:
        y = y + torch.matmul(x_outlier.float(), w_outlier.float())
    return _build.apply_epilogue(y, fuse).to(out_dtype)


@functools.cache
def _launcher():
    fn = _build.load("mix_gemm").mix_gemm_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mix_gemm(
    q_x: torch.Tensor,                        # int8 [M, K] | bf16 (a16)
    w: torch.Tensor,                          # int8 [K, N] | uint8 [K/2, N]
    x_scale: Optional[torch.Tensor],          # f32 [M, 1] (int8 q_x only)
    w_scale: torch.Tensor,                    # f32 [N] | [G, N]
    x_outlier: Optional[torch.Tensor] = None,  # bf16 [M, B]
    w_outlier: Optional[torch.Tensor] = None,  # bf16 [B, N]
    fuse: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
    x_zero: Optional[torch.Tensor] = None,    # f32 [M, 1] (QUIK)
    reduced_w: Optional[torch.Tensor] = None,  # f32 [N] (QUIK)
) -> torch.Tensor:
    """Returns y [M, N] in out_dtype (bf16 or f32)."""
    return _mix_gemm(q_x, w, x_scale, w_scale, x_outlier, w_outlier, fuse,
                     out_dtype, x_zero=x_zero, reduced_w=reduced_w)


def _mix_gemm(q_x, w, x_scale, w_scale, x_outlier, w_outlier, fuse,
              out_dtype, splits: Optional[int] = None, x_zero=None,
              reduced_w=None) -> torch.Tensor:
    """`mix_gemm`; `splits` forces the split-K factor S (1-8) instead of
    plan_mix's, so a card test can hold the result across plans."""
    if q_x.dtype != torch.int8:               # the a16 mode: kernel B
        if x_zero is not None or reduced_w is not None:
            raise ValueError("a zero point needs an int8 activation")
        return mix_gemm_a16(q_x, w, w_scale, x_outlier, w_outlier, fuse,
                            out_dtype)
    if q_x.device.type == "cpu":
        return mix_gemm_plain(q_x, w, x_scale, w_scale, x_outlier, w_outlier,
                              fuse, out_dtype, x_zero, reduced_w)
    if q_x.device.type != "cuda":
        raise ValueError(f"unsupported device {q_x.device}")
    fuse_code = _build.check_fuse(fuse, "mix_gemm")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} not supported")
    w4 = w.dtype == torch.uint8
    M, K = q_x.shape
    N = w.shape[1]
    if K % (32 if w4 else 16) or N % 16:
        raise ValueError(f"K ({K}) must be a multiple of {32 if w4 else 16} "
                         f"and N ({N}) of 16")
    dev = q_x.device
    G = _build.scale_groups(w_scale, K, what="mix_gemm")
    _build.require(q_x, torch.int8, (M, K), "q_x", dev)
    _build.require(w, w.dtype if w4 else torch.int8,
                   (K // 2, N) if w4 else (K, N), "w", dev)
    _build.require(x_scale.reshape(M), torch.float32, (M,), "x_scale", dev)
    _build.require(w_scale, torch.float32,
                   (G, N) if G > 1 else tuple(w_scale.shape), "w_scale", dev)
    if w_scale.numel() != G * N:
        raise ValueError(f"w_scale {tuple(w_scale.shape)} for N={N}")
    zp = _zero_point(x_zero, reduced_w, G > 1)
    if zp:
        _build.require(x_zero.reshape(M), torch.float32, (M,), "x_zero",
                       dev)
        _build.require(reduced_w, torch.float32, (N,), "reduced_w", dev)
    has_out = x_outlier is not None and w_outlier is not None
    Bo = 0
    if has_out:
        Bo = x_outlier.shape[-1]
        if Bo % 16:
            raise ValueError(f"outlier budget {Bo} must be a multiple of 16")
        _build.require(x_outlier, torch.bfloat16, (M, Bo), "x_outlier", dev)
        _build.require(w_outlier, torch.bfloat16, (Bo, N), "w_outlier", dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (q_x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), x_outlier.data_ptr() if has_out else None,
            w_outlier.data_ptr() if has_out else None, out.data_ptr(),
            x_zero.data_ptr() if zp else None,
            reduced_w.data_ptr() if zp else None)
    if splits is None:
        index = q_x.get_device()
        splits = plan_mix(M, N, K, w4, G, _build.sm_count(index),
                          _clusters(index, w4, G > 1, zp)).splits
    rc = _launcher()(*ptrs, M, N, K, Bo, G, int(w4), fuse_code,
                     int(out_dtype == torch.float32), splits, stream)
    _build.check(rc, "mix_gemm")
    mix_gemm.launches += 1
    mix_gemm.mode_launches[_mode(w4, G, zp)] += 1
    if fuse_code:
        mix_gemm.mode_launches[fuse] += 1
    return out


mix_gemm.launches = 0
mix_gemm.mode_launches = dict.fromkeys(MODES + EPILOGUES, 0)


def int8_matmul_dequant(
    q_x: torch.Tensor, q_w: torch.Tensor, x_scale: torch.Tensor,
    w_scale: torch.Tensor, x_outlier: Optional[torch.Tensor] = None,
    w_outlier: Optional[torch.Tensor] = None, fuse: str = "none",
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """mixq_tpu/ops/pallas/int8_matmul.py::int8_matmul_dequant's contract
    (the mixlib.int8FusedDequantize[Silu] kernel) on kernel 2."""
    return mix_gemm(q_x, q_w, x_scale, w_scale, x_outlier, w_outlier,
                    fuse=fuse, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# The expert-batched mode (MoE)
# ---------------------------------------------------------------------------

def mix_gemm_experts_plain(q_x: torch.Tensor, w: torch.Tensor,
                           x_scale: torch.Tensor,
                           w_scale: torch.Tensor) -> torch.Tensor:
    """PyTorch version of the expert mode, in JAX's order (expert_linear):
    the int32 accumulator of each expert's product in float64 (exact, as
    mix_gemm_plain's), rounded to f32, times x_scale [E, C, 1], then times
    w_scale [E, N]."""
    acc = torch.bmm(q_x.double(), w.double()).float()
    return acc * x_scale * w_scale[:, None, :]


@functools.cache
def _experts_launcher():
    fn = _build.load("mix_gemm").mix_gemm_experts_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mix_gemm_experts(
    q_x: torch.Tensor,                # int8 [E, C, K]
    w: torch.Tensor,                  # int8 [E, K, N]
    x_scale: torch.Tensor,            # f32 [E, C, 1]
    w_scale: torch.Tensor,            # f32 [E, N]
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Returns y [E, C, N] f32. `splits` forces the split-K factor S (1-8)
    instead of plan_mix's, so a card test can hold the result across
    plans."""
    if q_x.device.type == "cpu":
        return mix_gemm_experts_plain(q_x, w, x_scale, w_scale)
    if q_x.device.type != "cuda":
        raise ValueError(f"unsupported device {q_x.device}")
    E, C, K = q_x.shape
    N = w.shape[-1]
    if K % 16 or N % 16:
        raise ValueError(f"K ({K}) and N ({N}) must be multiples of 16")
    if E * -(-C // BM) > 65535:
        raise ValueError(f"{E} experts x {-(-C // BM)} M-tiles pass the "
                         "grid's 65535 rows")
    dev = q_x.device
    _build.require(q_x, torch.int8, (E, C, K), "q_x", dev)
    _build.require(w, torch.int8, (E, K, N), "w", dev)
    _build.require(x_scale, torch.float32, (E, C, 1), "x_scale", dev)
    _build.require(w_scale, torch.float32, (E, N), "w_scale", dev)
    out = torch.empty((E, C, N), dtype=torch.float32, device=dev)
    if splits is None:
        index = q_x.get_device()
        splits = plan_mix(C, N, K, False, 1, _build.sm_count(index),
                          _clusters(index, False, False, experts=True),
                          experts=E).splits
    rc = _experts_launcher()(q_x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
                             w_scale.data_ptr(), out.data_ptr(), E, C, N, K,
                             splits,
                             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "mix_gemm_experts")
    mix_gemm.launches += 1
    mix_gemm.mode_launches["w8a8_experts"] += 1
    return out
