"""T=1 decode attention over a head-major KV cache (kernel 3).

Replaces mixq_tpu/ops/pallas/flash_decode.py::flash_decode_attention (its
main-cache path) with the CUDA kernel in mixq_tpu_torch/csrc/flash_decode.cu.
bf16 or int8 cache with per-(token, head) scales, GQA, per-row valid lengths
and first valid slots (kv_start), and gemma2's score-scale override (`scale`,
default 1/sqrt(D)) and logit softcap (`softcap` > 0: tanh(s / cap) * cap
after the scale, before the mask), and ALiBi (`alibi_slopes` [n_q] f32:
slope * f32(slot) added after the softcap, before the mask, the Pallas
kernel's absolute form, mixq_tpu/ops/pallas/flash_decode.py:340-348: the
query's own -slope * q_pos is a constant of the row, which the softmax
drops), with the Pallas signature's meaning. The int8 mode repeats the
Pallas recipe: q and the probabilities are absmax-quantized so both dots
are int8 x int8.

One difference from the Pallas kernel: a row with no valid slot
(length <= kv_start) comes out as zeros. The Pallas kernel zeroes only rows
of length 0 and returns an average over masked slots when
kv_start >= length > 0; the decoder never produces such a row.

A sliding window reaches the kernel as its per-row start: the decoder
passes max(kv_start, kv_len - W) at T=1, as JAX does. The speculative
verify (T>1 in slot mode) launches it once per verify token at per-row
lengths (models/decoder.py::_verify_attend). Still to port (ROADMAP.md
Queue B): the token-major tail window.

`use_head_major_cache` is JAX's policy for which cache layout serving
takes (head-major for this kernel, or batch-major for kernel 8), read as on
the accelerator whatever the device, so the CPU tests take the layout the
card does.

The kernel splits each (kv head, batch row)'s valid slots over a
thread-block cluster of R blocks; `plan_flash` chooses R from static shapes
and the card's cluster occupancy (never from `lengths`, so a captured
decode step keeps its plan), and `rank_bounds` is the run-time cut of a
row's slots between the ranks, as the kernel computes it.

`flash_decode_attention` launches the kernel for CUDA tensors and runs
`flash_decode_plain`, the same arithmetic in PyTorch ops, for CPU tensors;
`flash_decode_level` sizes one flipped probability level per output row,
the unit of the kernel's tolerance against the plain version on a peaked
softmax.
A group past 8 query heads a kv head (Falcon-7B's 71, StarCoder2's 9,
ChatGLM3's 16) runs in head tiles (`head_tile`): T = ceil(g / 8) blocks
of G = ceil(g / T) heads each take the stripe, one launch; there is no
softcap in that mode (ValueError).

Besides its total `launches`, the wrapper counts its softcap and ALiBi
launches in `mode_launches["softcap"]` and `mode_launches["alibi"]`, its
launches whose (tile) group is not a power of two in
`mode_launches["g3"]`, "g5", "g6" and "g7", its launches at a group past
8 in "tiled", and at head dim 96 in `mode_launches["d96"]`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.utils.arith import true_div

SOURCE = "mixq_tpu_torch/csrc/flash_decode.cu"
REPLACES = "mixq_tpu/ops/pallas/flash_decode.py:442"
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
SMEM_LIMIT = 227 * 1024          # H100 dynamic shared memory per block
LAUNCH_SMEM = 226 * 1024         # a launch: room left for static smem
# the GQA groups n_q / n_kv the kernel is built for (a group past 8 runs in
# head tiles of these: head_tile); with a softcap only the power-of-two
# ones (no family with a softcap has another group)
GROUPS = (1, 2, 3, 4, 5, 6, 7, 8)
MAX_TILE = GROUPS[-1]
SOFTCAP_GROUPS = (1, 2, 4, 8)
# the groups that are not a power of two, each counted as a mode of its
# own (mode_launches["g7"], ...), as is the head dim 96 ("d96") in both
# attention kernels
GROUP_MODES = (3, 5, 6, 7)
# the bytes of one cache row (D * itemsize) it reads in whole 16-byte
# chunks: the powers of two, and 96 / 192 (D = 96, Phi-3)
ROW_BYTES = (16, 32, 64, 96, 128, 192, 256, 512)
# the kernel's shape (csrc/flash_decode.cu): warps a block, the cluster
# sizes R it is planned at, the blocks an SM holds for the default cluster
# table (the card's own table replaces it)
WARPS, SPLITS, BLOCKS_PER_SM = 4, (1, 2, 4, 8), 8
# block steps a rank walks at least, on a row that fills the cache: under
# it a rank's fixed costs (q, the reductions, the cluster barriers) outweigh
# its share of the stream (chip_smoke.py's small-batch rows time R = 1-8)
MIN_STEPS = 4
# its load pipelines: a per-lane cp.async ring in shared memory of
# RING_STAGES stages of 2 rows, or 4 rows a lane in registers
RING_STAGES = 4

Rows = Union[int, torch.Tensor, None]


def head_tile(g: int) -> Tuple[int, int]:
    """(T, G): a group of g query heads a kv head as the kernels run it,
    T = ceil(g / 8) head tiles of G = ceil(g / T) heads, the last tile
    masked past g (csrc/flash_decode.cu::head_tiles, tile_group): 71 ->
    (9, 8), 9 -> (2, 5), 12 -> (2, 6), 16 -> (2, 8); g <= 8 -> (1, g)."""
    if g < 1:
        raise ValueError(f"group {g} must be >= 1")
    T = -(-g // MAX_TILE)
    return T, -(-g // T)


def _rows(x: Rows, B: int, device) -> torch.Tensor:
    return torch.as_tensor(0 if x is None else x, dtype=torch.int32,
                           device=device).expand(B)


def _score_scale(scale: Optional[float], D: int) -> float:
    """The score scale, 1/sqrt(D) as the Pallas kernel computes it unless
    overridden."""
    return scale if scale is not None else 1.0 / (D ** 0.5)


def _layer_view(k, v, k_scale, v_scale, layer):
    if k.dim() == 5:
        if layer is None:
            raise ValueError("a 5D stacked cache needs a layer index")
        k, v = k[layer], v[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    return k, v, k_scale, v_scale


def _softmax_parts(q, k, v, lengths, k_scale, v_scale, kv_start, layer,
                   softcap, scale, alibi_slopes):
    """The plain version's scores and softmax numerator: (p = exp(s - max)
    [B, n_kv, g, S] f32, l = sum(p), valid [B, S], live, the layer's v and
    v_scale, quantized)."""
    k, v, k_scale, v_scale = _layer_view(k, v, k_scale, v_scale, layer)
    B, n_q, D = q.shape
    n_kv, _, S, _ = k.shape
    g = n_q // n_kv
    dev = q.device
    lengths = _rows(lengths, B, dev).clamp(max=S)
    starts = _rows(kv_start, B, dev).clamp(min=0)
    pos = torch.arange(S, device=dev)
    valid = (pos[None] < lengths[:, None]) & (pos[None] >= starts[:, None])
    live = (lengths > starts).float()[:, None, None, None]
    scale = _score_scale(scale, D)
    qf = q.float().reshape(B, n_kv, g, D)
    kt = k.permute(1, 0, 3, 2)                       # [B, n_kv, D, S]
    quantized = k_scale is not None
    if quantized:
        q_scale = torch.clamp_min(
            true_div(qf.abs().amax(-1, keepdim=True), 127.0), 1e-8)
        q_i8 = torch.clamp(torch.round(qf / q_scale), -127, 127)
        acc = torch.matmul(q_i8.double(), kt.double()).float()
        ks = k_scale[..., :S].permute(1, 0, 2)[:, :, None, :]
        qk = acc * q_scale * ks * scale
    else:
        qk = torch.matmul(qf, kt.float()) * scale
    if softcap:
        qk = torch.tanh(true_div(qk, softcap)) * softcap
    if alibi_slopes is not None:
        qk = qk + (alibi_slopes.reshape(n_kv, g)[None, :, :, None]
                   * pos.float())
    qk = torch.where(valid[:, None, None, :], qk, MASK_VALUE)
    m = qk.amax(-1, keepdim=True)
    p = torch.exp(qk - m)
    return p, p.sum(-1, keepdim=True), valid, live, v, v_scale, quantized


def flash_decode_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: Rows,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, kv_start: Rows = None,
    layer: Optional[int] = None, softcap: float = 0.0,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PyTorch version of the kernel, in the Pallas kernel's order of
    operations. The int8 dots run in float64, which holds them exactly."""
    p, l, _, live, v, v_scale, quantized = _softmax_parts(
        q, k, v, lengths, k_scale, v_scale, kv_start, layer, softcap, scale,
        alibi_slopes)
    B, n_q, D = q.shape
    S = v.shape[2]
    vv = v.permute(1, 0, 2, 3)                       # [B, n_kv, S, D]
    if quantized:
        vs = v_scale[..., :S].permute(1, 0, 2)[:, :, None, :]
        p2 = p * vs
        p_scale = torch.clamp_min(true_div(p2.amax(-1, keepdim=True), 127.0),
                                  1e-20)
        p_i8 = torch.round(p2 / p_scale)
        pv = torch.matmul(p_i8.double(), vv.double()).float() * p_scale
    else:
        pv = torch.matmul(p.to(torch.bfloat16).float(), vv.float())
    o = pv / l * live
    return o.reshape(B, n_q, D).to(q.dtype)


def flash_decode_level(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: Rows,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None, kv_start: Rows = None,
    layer: Optional[int] = None, softcap: float = 0.0,
    scale: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, n_q] f32: the most that one probability level, rounded the other
    way, moves an output row of flash_decode_plain. int8: a level of p_i8
    is p_scale and |v_i8| <= 127, so 127 * p_scale / l = max(p * v_scale) /
    l; bf16: a bf16 ulp of p <= 1 is at most 2^-8, so 2^-8 * max|v| / l
    over the row's valid slots. An exp() or tanh() ulp between two
    implementations flips such roundings now and then; a peaked softmax
    (small l) makes each flip large."""
    p, l, valid, _, v, v_scale, quantized = _softmax_parts(
        q, k, v, lengths, k_scale, v_scale, kv_start, layer, softcap, scale,
        alibi_slopes)
    B, n_q, _ = q.shape
    S = v.shape[2]
    if quantized:
        vs = v_scale[..., :S].permute(1, 0, 2)[:, :, None, :]
        top = (p * vs).amax(-1)
    else:
        vmax = torch.where(valid[:, None, :, None],
                           v.permute(1, 0, 2, 3).float().abs(), 0.0)
        top = 2.0 ** -8 * vmax.amax((-1, -2))[:, :, None]
    return (top / l[..., 0]).reshape(B, n_q)


def uses_ring(g: int, int8: bool) -> bool:
    """Whether an instantiation reads through the cp.async ring (else
    registers): the pipeline measured faster for it on the H100
    (csrc/flash_decode.cu::uses_ring)."""
    return not int8 or g >= 4


def unroll(ring: bool) -> int:
    """Rows a lane reads at once: a ring stage's, or its registers'."""
    return 2 if ring else 4


def row_lanes(row_bytes: int) -> int:
    """Lanes a cache row takes (csrc/cp_async.cuh::pow2_chunks): its
    16-byte chunks rounded up to a power of two."""
    n = 1
    while n < row_bytes // 16:
        n *= 2
    return n


def rows_per_step(D: int, kv_itemsize: int) -> int:
    """Cache rows a warp reads at once: one 16-byte chunk a lane, a row on
    row_lanes lanes."""
    return 32 // row_lanes(D * kv_itemsize)


def rank_bounds(start: int, length: int, unit: int,
                R: int) -> List[Tuple[int, int]]:
    """Each cluster rank's part [a, b) of a row's valid slots
    [start, length) (csrc/cluster.cuh::rank_part): ceil(n / unit) whole
    units of `unit` slots split R ways as kernels 2, A and B split their
    stages, the first n_units % R ranks one unit more, the last part cut at
    `length`; an empty range gives every rank an empty part."""
    n = -(-(length - start) // unit) if length > start else 0
    base, extra = divmod(n, R)
    out = []
    for r in range(R):
        first = r * base + min(r, extra)
        a = start + first * unit
        b = start + (first + base + (r < extra)) * unit
        out.append((min(a, length), min(b, length)))
    return out


def part_rows(S: int, rpw: int, R: int) -> int:
    """The longest part of S slots a rank takes: whole warp steps."""
    steps = -(-S // rpw)
    return -(-steps // R) * rpw


def smem_bytes(g: int, S: int, D: int, kv_itemsize: int = 1,
               splits: int = 1) -> int:
    """Dynamic shared memory of one block at R = `splits`
    (csrc/flash_decode.cu's launch): the cp.async ring, q in
    f32 and int8, the warps' p.v partials, the part's scores g*P*4 and,
    int8, its k and v scales."""
    P = part_rows(S, rows_per_step(D, kv_itemsize), splits)
    ring = uses_ring(g, kv_itemsize == 1)
    ring_bytes = 128 * unroll(True) * RING_STAGES * 16 if ring else 0
    return (ring_bytes + g * D * 4 + g * D + WARPS * g * D * 4 + g * P * 4
            + (2 * P * 4 if kv_itemsize == 1 else 0))


def _row_smem(g: int, S: int, D: int) -> int:
    """Shared memory of a block holding a whole row's scores g*S*4, the
    warps' p.v partials and q: the gate on which shapes the kernel takes
    (and so which serving takes the head-major cache)."""
    return g * S * 4 + WARPS * g * D * 4 + g * D * 4 + g * D


def flash_decode_supported(g: int, S: int, D: int, kv_itemsize: int) -> bool:
    """Whether the kernel takes these shapes: any group (past 8 in head
    tiles), a head dim it reads in whole 16-byte chunks, and a whole row's
    scores of a tile's heads in shared memory."""
    return (g >= 1 and D * kv_itemsize in ROW_BYTES
            and _row_smem(head_tile(g)[1], S, D) <= SMEM_LIMIT)


class FlashPlan(NamedTuple):
    """Kernel 3's launch plan (plan_flash)."""
    splits: int                # R: blocks (one cluster) per (kv head, row)
                               # and head tile
    blocks: int                # the grid: n_kv * T * B * R
    step: int                  # slots a block reads at once
    smem: int                  # dynamic shared memory of a block


@functools.lru_cache(maxsize=1024)       # every decode step asks again
def plan_flash(B: int, n_kv: int, g: int, S: int, D: int, int8: bool,
               sm_count: int, clusters: Optional[Sequence[int]] = None
               ) -> FlashPlan:
    """The kernel's launch plan from static shapes only (never the rows'
    lengths): the tiles are the n_kv * B (kv head, batch row) stripes
    times the group's T head tiles (head_tile; G heads a block), the
    stages S's chunks of MIN_STEPS block steps (a block step: WARPS *
    rows_per_step * unroll slots), and R is `_build.split_size`'s rule over
    the cluster sizes SPLITS: the largest R, at most one chunk a rank,
    whose clusters of R blocks all fit on the card at once
    (`clusters[R - 1]`: the card's count, `_clusters`; by default
    BLOCKS_PER_SM blocks per SM packed perfectly), and R = 1 when the
    stripes alone fill the card. Then the smallest R at least that whose
    part's scores fit in shared memory. `clusters`, when given, is a tuple
    (the plan is cached)."""
    esize = 1 if int8 else 2
    T, G = head_tile(g)
    rpw = rows_per_step(D, esize)
    step = WARPS * rpw * unroll(uses_ring(G, int8))
    tiles, stages = n_kv * B * T, max(1, S // (MIN_STEPS * step))
    R = _build.split_size(tiles, stages, sm_count, clusters, BLOCKS_PER_SM,
                          SPLITS)
    R = next((r for r in SPLITS if r >= R
              and smem_bytes(G, S, D, esize, r) <= LAUNCH_SMEM), SPLITS[-1])
    return FlashPlan(R, tiles * R, step, smem_bytes(G, S, D, esize, R))


def _clusters(index: int, int8: bool, g: int, softcap: bool, S: int,
              D: int) -> Tuple[int, ...]:
    """The card's clusters of 1..8 blocks of the instantiation of group g
    (its head tiles' G) at S slots of head dim D (its shared memory) at
    once."""
    return _build.cluster_table("flash_decode",
                                "flash_decode_max_active_clusters", index,
                                int(int8), g, int(softcap), S, D)


def use_head_major_cache(attn_impl: str, model_cfg, max_seq: int,
                         kv_itemsize: int) -> bool:
    """JAX's single policy point (mixq_tpu/ops/pallas/flash_decode.py::
    use_head_major_cache) for "should serving use the head-major flash
    cache?", read as on the accelerator:
      "flash"  opt-in: head-major whenever this kernel takes the shapes;
               also the only way for sliding-window, ALiBi and gemma2-style
               models, and a binding alternating window (a cache longer
               than gemma2's window) stays batch-major;
      "auto"   (the default) head-major for int8 KV at max_seq >= 128,
               batch-major otherwise (bf16 KV, short caches, window, ALiBi
               and gemma2-style models);
      anything else: batch-major."""
    if attn_impl not in ("flash", "auto"):
        return False
    if ((model_cfg.sliding_window is not None or model_cfg.alibi)
            and attn_impl != "flash"):
        return False
    if (model_cfg.attn_logit_softcap is not None
            or model_cfg.query_pre_attn_scalar is not None
            or model_cfg.sliding_window_pattern != 1):
        if attn_impl != "flash":
            return False
        if (model_cfg.sliding_window_pattern != 1
                and model_cfg.sliding_window is not None
                and max_seq > model_cfg.sliding_window):
            return False
    if attn_impl == "auto" and (kv_itemsize != 1 or max_seq < 128):
        return False
    return flash_decode_supported(
        model_cfg.num_attention_heads // model_cfg.num_key_value_heads,
        max_seq, model_cfg.head_dim_, kv_itemsize)


@functools.cache
def _lib():
    lib = _build.load("flash_decode")
    lib.flash_decode_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float]
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.flash_decode_launch.restype = ctypes.c_int
    return lib


def _device_rows(x: Rows, B: int, device, name: str) -> Optional[torch.Tensor]:
    """A per-row int32 operand as a [B] tensor on the card; None for None
    and for a Python int, which the kernel takes as a scalar."""
    if x is None or isinstance(x, int):
        return None
    if (x.device != device or x.dtype != torch.int32
            or tuple(x.shape) != (B,) or not x.is_contiguous()):
        raise ValueError(f"{name} must be an int or a contiguous int32 [B] "
                         f"tensor on {device}")
    return x


def flash_decode_attention(
    q: torch.Tensor,                          # [B, n_q, D] bf16
    k: torch.Tensor,                          # [(L,) n_kv, B, S, D]
    v: torch.Tensor,
    lengths: Rows,                            # int or [B] int32
    k_scale: Optional[torch.Tensor] = None,   # [(L,) n_kv, B, S or Sp] f32
    v_scale: Optional[torch.Tensor] = None,
    kv_start: Rows = None,                    # None, int or [B] int32
    layer: Optional[int] = None,              # layer index of a 5D cache
    softcap: float = 0.0,                     # > 0: gemma2 logit softcap
    scale: Optional[float] = None,            # score scale; None: 1/sqrt(D)
    alibi_slopes: Optional[torch.Tensor] = None,   # [n_q] f32 ALiBi slopes
) -> torch.Tensor:
    """Returns the attention output [B, n_q, D] in q.dtype."""
    return _flash(q, k, v, lengths, k_scale, v_scale, kv_start, layer,
                  softcap, scale, alibi_slopes)


def _flash(q, k, v, lengths, k_scale, v_scale, kv_start, layer, softcap,
           scale, alibi_slopes=None,
           splits: Optional[int] = None) -> torch.Tensor:
    """`flash_decode_attention`; `splits` forces R (1, 2, 4 or 8) instead
    of plan_flash's, so a card test can hold the result across plans."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, k_scale, v_scale,
                                  kv_start, layer, softcap, scale,
                                  alibi_slopes)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    k, v, k_scale, v_scale = _layer_view(k, v, k_scale, v_scale, layer)
    B, n_q, D = q.shape
    n_kv, Bk, S, Dk = k.shape
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    if Bk != B or Dk != D or n_q % n_kv:
        raise ValueError(f"shapes q {tuple(q.shape)} / k {tuple(k.shape)}: "
                         f"need matching B, D and n_kv dividing n_q")
    esize = 1 if quantized else 2
    if D * esize not in ROW_BYTES:
        raise ValueError(f"head dim {D} not supported for {kv_dtype}")
    g = n_q // n_kv
    G = head_tile(g)[1]
    dev = q.device
    if softcap < 0:
        raise ValueError(f"softcap {softcap} must be >= 0 (0: none)")
    if softcap and g not in SOFTCAP_GROUPS:
        raise ValueError(f"a softcap needs n_q/n_kv in {SOFTCAP_GROUPS}, "
                         f"not {g}")
    if (q.dtype != torch.bfloat16 or not q.is_contiguous()
            or q.data_ptr() % 16):
        raise ValueError("q must be a contiguous, 16-byte aligned bf16 "
                         "tensor")
    for t, name in ((k, "k"), (v, "v")):
        if (t.device != dev or t.dtype != kv_dtype or t.shape != k.shape
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous {kv_dtype} "
                             f"{tuple(k.shape)} tensor on {dev}")
    Sp = S
    if quantized:
        Sp = k_scale.shape[-1]
        if Sp not in (S, -(-S // 128) * 128):
            raise ValueError(f"scale length {Sp} is neither S={S} nor S "
                             "padded to a multiple of 128")
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != (n_kv, B, Sp)
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous f32 "
                                 f"{(n_kv, B, Sp)} tensor on {dev}")
    if alibi_slopes is not None:
        _build.require(alibi_slopes, torch.float32, (n_q,), "alibi_slopes",
                       dev)
    if _row_smem(G, S, D) > SMEM_LIMIT:
        raise ValueError(f"a row's G*S*4 scores ({_row_smem(G, S, D)} bytes "
                         f"of shared memory with the reduction buffers) "
                         f"exceed {SMEM_LIMIT}")
    if splits is None:
        index = q.get_device()
        splits = plan_flash(B, n_kv, g, S, D, quantized,
                            _build.sm_count(index),
                            _clusters(index, quantized, g, softcap > 0, S,
                                      D)).splits
    if (splits not in SPLITS
            or smem_bytes(G, S, D, esize, splits) > LAUNCH_SMEM):
        raise ValueError(f"{splits} splits: R must be one of {SPLITS} with "
                         f"the part's scores in {LAUNCH_SMEM} bytes")
    lib = _lib()
    len_t = _device_rows(lengths, B, dev, "lengths")
    st_t = _device_rows(kv_start, B, dev, "kv_start")
    if isinstance(kv_start, int) and kv_start:      # kept alive past launch
        st_t = _rows(kv_start, B, dev).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        None if len_t is None else len_t.data_ptr(),
        lengths if len_t is None else 0,
        None if st_t is None else st_t.data_ptr(),
        None if alibi_slopes is None else alibi_slopes.data_ptr(),
        out.data_ptr(), B, n_kv, g, S, Sp, D, _score_scale(scale, D),
        softcap, int(quantized), splits, stream)
    _build.check(rc, "flash_decode")
    flash_decode_attention.launches += 1
    modes = flash_decode_attention.mode_launches
    if softcap:
        modes["softcap"] += 1
    if alibi_slopes is not None:
        modes["alibi"] += 1
    count_shape_modes(modes, g, D)
    return out


def count_shape_modes(modes: dict, g: int, D: int) -> None:
    """Counts a launch whose instantiation's group (a tile's G) is not a
    power of two, a launch at a group past 8 ("tiled") and at head dim 96,
    in a wrapper's mode_launches."""
    T, G = head_tile(g)
    if G in GROUP_MODES:
        modes[f"g{G}"] += 1
    if T > 1:
        modes["tiled"] += 1
    if D == 96:
        modes["d96"] += 1


SHAPE_MODES = tuple(f"g{g}" for g in GROUP_MODES) + ("tiled", "d96")
flash_decode_attention.launches = 0
flash_decode_attention.mode_launches = {
    "softcap": 0, "alibi": 0, **dict.fromkeys(SHAPE_MODES, 0)}
