"""T=1 decode attention over a batch-major KV cache (kernel 8).

Replaces mixq_tpu/ops/pallas/decode_attention.py::decode_attention with the
CUDA kernel in mixq_tpu_torch/csrc/decode_attention.cu. q [B, n_q, D] bf16
against one layer of the batch-major cache, k, v [B, S, n_kv, D] bf16 or
int8 with per-(token, head) scales [B, S, n_kv] f32, GQA g = n_q / n_kv in
GROUPS (1-8; with a softcap 1, 2, 4, 8) or past 8 in head tiles of those
(kernels.flash_decode.head_tile; no softcap), head dims whose row is a power of
two of 16-byte chunks or D = 96 (ROW_BYTES), per-row valid lengths and first valid positions (each an int
or [B] int32). The recipe is the Pallas kernel's, which is `attend`'s over
the cache: K and V widened to f32, scores = (q . k) * scale * k_scale,
masked, a normalised softmax, p * v_scale, and the sum of p . v in f32.

Beyond `decode_attention`'s interface it takes what `attend` over a
batch-major cache at T=1 needs, so that the decoder's decode step runs here:
  ring     the cache is a ring (sliding-window models): `kv_len` counts
           absolute positions and slot s holds position
           s + S * floor((kv_len - 1 - s) / S) (negative: never written);
  kv_start the first valid absolute position; the decoder passes
           max(kv_start, kv_len - W) on a windowed layer, which is
           `attend`'s window mask for the query at kv_len - 1;
  scale    the score scale (default 1/sqrt(D), gemma2's
           query_pre_attn_scalar^-0.5), and `softcap` > 0 (gemma2:
           tanh(s / cap) * cap after the scale and k_scale, before the mask);
  alibi_slopes  [n_q] f32 (Baichuan-13B): `attend`'s bias
           slope * f32(kv_pos - q_pos), q_pos = kv_len - 1, added before
           the mask (mixq_tpu/models/layers.py:824-830), on ring positions
           too. With a softcap it raises ValueError: the kernel caps its
           raw scores after their max (the cap is monotone), and the bias
           would have to come after the cap and before the max; no ported
           family has both.

A row with no valid position gets what JAX gives it: every score is masked
to -1e30, so the softmax is uniform over all S slots and the row is the mean
of p = 1/S times v_scale times v over every slot, written or not.

The scale is 1/sqrt(D) rounded as `attend` computes it (the f32 reciprocal
of the f32 sqrt, the function the decoder replaces); the Pallas kernel
rounds the Python double 1/D**0.5 to f32, at most one f32 ulp away.

The kernel splits each (kv head, batch row)'s valid positions over a
thread-block cluster of R blocks, each with an online softmax over tiles of
its part, merged in rank order; `plan_decode` chooses R from static shapes
and the card's cluster occupancy (never from `kv_len` or `kv_start`, so a
captured decode step keeps its plan), and `kernels.flash_decode.
rank_bounds` is the run-time cut of a row's positions between the ranks,
in units of UNIT positions.

`decode_attention` launches the kernel for CUDA tensors and runs
`decode_attention_plain`, which is `attend` at T=1 (PyTorch ops), for CPU
tensors. Besides its total `launches` the wrapper counts its
launches by mode in `mode_launches`: "int8" or "bf16" (the KV type), "ring",
"softcap" and "alibi", and as kernel 3 does, "g3", "g5", "g6", "g7" (a
group that is not a power of two), "tiled" (a group past 8) and "d96"
(head dim 96).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.kernels.flash_decode import (GROUPS, ROW_BYTES,
                                                 SHAPE_MODES,
                                                 SOFTCAP_GROUPS,
                                                 count_shape_modes,
                                                 head_tile)

SOURCE = "mixq_tpu_torch/csrc/decode_attention.cu"
REPLACES = "mixq_tpu/ops/pallas/decode_attention.py:85"
# The kernel against its plain version: two bf16 ulps of |y| plus this
# much. Both sides compute in f32 from the same widened operands and round
# once to bf16, so they differ by the f32 summation order (tensor-core dots,
# and the tiles and ranks of an online softmax, against one whole-row
# softmax), by p's split into two bf16 halves in the kernel's p . v (2^-17
# of p) and by an ulp of expf or tanhf: ~1e-6 of max|v| on the inputs here,
# which may flip a bf16 rounding (the two ulps). A kernel that quantizes the
# probabilities to int8, as kernel 3's recipe does, misses by more than 1.5x
# this (tests/test_torch_decode_attention.py).
DECODE_ATOL = 1e-4
Rows = Union[int, torch.Tensor, None]

# The kernel's shape (csrc/decode_attention.cu): warps a block, the cluster
# sizes R it is planned at, the blocks an SM holds for the default cluster
# table (the card's own table replaces it), the positions of the rank cut
# (kUnit), and the head-dim values of a warp's p . v slice (kSlice).
WARPS, SPLITS, BLOCKS_PER_SM, UNIT, SLICE = 4, (1, 2, 4, 8), 4, 16, 128
# stages a rank walks at least (K and V alike), on a row that fills the
# cache: under it a rank's fixed costs (q's fragments, the merge, the cluster
# barriers) outweigh its share of the stream
MIN_STAGES = 2


def stage_rows(D: int) -> int:
    """Positions a ring stage holds (stage_rows): 16 for each warp on one
    of the D / SLICE head-dim slices of a V row."""
    return 16 * WARPS // max(1, D // SLICE)


class DecodePlan(NamedTuple):
    """Kernel 8's launch plan (plan_decode)."""
    splits: int                # R: blocks (one cluster) per (kv head, row)
                               # and head tile
    blocks: int                # the grid: n_kv * T * B * R
    stage: int                 # positions a ring stage holds


@functools.lru_cache(maxsize=1024)       # every decode step asks again
def plan_decode(B: int, n_kv: int, g: int, S: int, D: int, int8: bool,
                softcap: bool, sm_count: int,
                clusters: Optional[Sequence[int]] = None) -> DecodePlan:
    """The kernel's launch plan from static shapes only (never the rows'
    lengths or starts), by `_build.split_size`'s rule as kernel 3's
    `plan_flash`: the tiles are the n_kv * B (kv head, batch row) stripes
    times the group's head tiles (head_tile), the chunks S's runs of MIN_STAGES ring stages, and R is the largest of
    SPLITS, at most one chunk a rank, whose clusters of R blocks all fit on
    the card at once (`clusters[R - 1]`: the card's count for this
    instantiation, `_clusters`; by default BLOCKS_PER_SM blocks per SM
    packed perfectly); R = 1 when the stripes alone fill the card. The
    online softmax keeps one tile of scores, so neither S nor R bounds the
    launch's shared memory (`launch_smem`). `int8` and `softcap` name the
    instantiation whose table `clusters` is; `clusters`, when given, is a
    tuple (the plan is cached)."""
    del int8, softcap
    P = stage_rows(D)
    tiles, chunks = n_kv * B * head_tile(g)[0], max(1, S // (MIN_STAGES * P))
    R = _build.split_size(tiles, chunks, sm_count, clusters, BLOCKS_PER_SM,
                          SPLITS)
    return DecodePlan(R, tiles * R, P)


def launch_smem(int8: bool, g: int, D: int) -> int:
    """The dynamic shared memory of one block of the instantiation of group
    g (its head tiles' G) at head dim D, as the library's launch takes it
    (decode_attention_smem_bytes)."""
    return _lib().decode_attention_smem_bytes(int(int8), g, D)


def _clusters(index: int, int8: bool, g: int, softcap: bool,
              D: int) -> Tuple[int, ...]:
    """The card's clusters of 1..8 blocks of one instantiation at head dim
    D (its shared memory) at once."""
    return _build.cluster_table("decode_attention",
                                "decode_attention_max_active_clusters",
                                index, int(int8), g, int(softcap), D)


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: Rows,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, kv_start: Rows = None,
    ring: bool = False, scale: Optional[float] = None, softcap: float = 0.0,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PyTorch version of the kernel: `attend` over the cache layer for the
    query at kv_len - 1 of each row."""
    # imported here: models.layers imports this package
    from mixq_tpu_torch.models.layers import attend

    B = q.shape[0]
    lens = torch.as_tensor(kv_len, dtype=torch.int64,
                           device=q.device).expand(B)
    starts = (None if kv_start is None else torch.as_tensor(
        kv_start, device=q.device).expand(B))
    return attend(q[:, None], k, v, (lens - 1)[:, None], lens, starts,
                  k_scale=k_scale, v_scale=v_scale, scale=scale,
                  softcap=softcap or None, ring=ring,
                  alibi=alibi_slopes)[:, 0]


@functools.cache
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3
        + [ctypes.c_void_p])
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem_bytes.restype = ctypes.c_int
    return lib


def _device_rows(x: Rows, B: int, device, name: str):
    """(pointer or None, scalar) for a per-row int operand: a Python int is
    passed as a scalar, a tensor as a contiguous int32 [B] on the card."""
    if x is None:
        return None, 0
    if isinstance(x, int):
        return None, x
    if (x.device != device or x.dtype != torch.int32
            or tuple(x.shape) != (B,) or not x.is_contiguous()):
        raise ValueError(f"{name} must be an int or a contiguous int32 [B] "
                         f"tensor on {device}")
    return x.data_ptr(), 0


def decode_attention(
    q: torch.Tensor,                          # [B, n_q, D] bf16
    k: torch.Tensor,                          # [B, S, n_kv, D] int8 | bf16
    v: torch.Tensor,
    kv_len: Rows,                             # int or [B] int32
    k_scale: Optional[torch.Tensor] = None,   # [B, S, n_kv] f32 (int8 KV)
    v_scale: Optional[torch.Tensor] = None,
    kv_start: Rows = None,                    # None, int or [B] int32
    *,
    ring: bool = False,                       # ring cache (absolute kv_len)
    scale: Optional[float] = None,            # score scale; None: 1/sqrt(D)
    softcap: float = 0.0,                     # > 0: gemma2 logit softcap
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns the attention output [B, n_q, D] in q.dtype."""
    return _decode(q, k, v, kv_len, k_scale, v_scale, kv_start, ring, scale,
                   softcap, alibi_slopes)


def _decode(q, k, v, kv_len, k_scale, v_scale, kv_start, ring, scale,
            softcap, alibi_slopes=None,
            splits: Optional[int] = None) -> torch.Tensor:
    """`decode_attention`; `splits` forces R (1, 2, 4 or 8) instead of
    plan_decode's, so a card test can hold the result across plans."""
    if softcap < 0:
        raise ValueError(f"softcap {softcap} must be >= 0 (0: none)")
    if alibi_slopes is not None and softcap:
        raise ValueError("decode_attention: ALiBi with a softcap is not "
                         "supported (the kernel caps scores after their max)")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, k_scale, v_scale,
                                      kv_start, ring, scale, softcap,
                                      alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, n_q, D = q.shape
    Bk, S, n_kv, Dk = k.shape
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    if Bk != B or Dk != D or n_q % n_kv:
        raise ValueError(f"shapes q {tuple(q.shape)} / k {tuple(k.shape)}: "
                         f"need matching B, D and n_kv dividing n_q")
    esize = 1 if quantized else 2
    if D * esize not in ROW_BYTES:
        raise ValueError(f"head dim {D} not supported for {kv_dtype}")
    if softcap and n_q // n_kv not in SOFTCAP_GROUPS:
        raise ValueError(f"a softcap needs n_q/n_kv in {SOFTCAP_GROUPS}, "
                         f"not {n_q // n_kv}")
    dev = q.device
    _build.require(q, torch.bfloat16, (B, n_q, D), "q", dev)
    for t, name in ((k, "k"), (v, "v")):
        _build.require(t, kv_dtype, (B, S, n_kv, D), name, dev)
    if quantized:                 # read one f32 at a time: any offset
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != (B, S, n_kv)
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous f32 "
                                 f"{(B, S, n_kv)} tensor on {dev}")
    if alibi_slopes is not None:
        _build.require(alibi_slopes, torch.float32, (n_q,), "alibi_slopes",
                       dev)
    if scale is None:             # attend's f32 1 / sqrt(D)
        scale = float(1.0 / torch.sqrt(torch.tensor(float(D))))
    g = n_q // n_kv
    if splits is None:
        index = q.get_device()
        splits = plan_decode(B, n_kv, g, S, D, quantized, softcap > 0,
                             _build.sm_count(index),
                             _clusters(index, quantized, g, softcap > 0,
                                       D)).splits
    if splits not in SPLITS:
        raise ValueError(f"{splits} splits: R must be one of {SPLITS}")
    len_p, len_all = _device_rows(kv_len, B, dev, "kv_len")
    st_p, st_all = _device_rows(kv_start, B, dev, "kv_start")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        len_p, len_all, st_p, st_all,
        None if alibi_slopes is None else alibi_slopes.data_ptr(),
        out.data_ptr(),
        B, S, n_kv, g, D, scale, softcap, int(quantized), int(ring), splits,
        stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    modes = decode_attention.mode_launches
    modes["int8" if quantized else "bf16"] += 1
    if ring:
        modes["ring"] += 1
    if softcap:
        modes["softcap"] += 1
    if alibi_slopes is not None:
        modes["alibi"] += 1
    count_shape_modes(modes, g, D)
    return out


decode_attention.launches = 0
decode_attention.mode_launches = {"int8": 0, "bf16": 0, "ring": 0,
                                  "softcap": 0, "alibi": 0,
                                  **dict.fromkeys(SHAPE_MODES, 0)}
