"""PyTorch port, kernel 8's launch plan and its cluster split on the CPU.

`kernels/decode_attention.py::plan_decode` on the served shapes (Mistral-7B's
32/8 heads of 128 with int8 KV, Llama-2-7B's 32/32 with bf16 KV, Gemma-2-9B's
16/8 heads of 256 with int8 KV and the softcap) at B = 1, 8, 16, 64 and
S = 512, 4096, 32768, with the H100's cluster occupancy and with the
default one: R one of 1, 2, 4, 8, at least MIN_STAGES ring stages a rank,
every cluster on the card at once, and R = 1 wherever the (kv head, batch
row) stripes alone fill the card. (The block's shared memory is the
library's own figure, held within a launch's limit by a card test.)

The rank cut (`kernels.flash_decode.rank_bounds`, csrc/cluster.cuh::
rank_part) over a ring row's positions past the wrap: each part of [lo, hi)
once, in order, in units of UNIT positions, and a part's slots advanced from
its first slot wrap at most once, as the kernel walks them.

The kernel's split recipe, emulated in PyTorch: each rank walks its part in
tiles (the kernel's tile_rows<G>, and 16-position tiles to exercise the
rescale), keeps an online softmax (the running max, l and acc rescaled by
exp(m_old - m_new)), takes p . v with p split into a bf16 high half and a
bf16 low half, and the ranks merge (m, l, acc) in rank order, an empty
rank's weight 0. Held against the Pallas decode_attention(interpret=True)
and JAX's `attend` (ring past the wrap, window start, softcap, scale) at
R = 1, 2, 4, 8 within DECODE_ATOL (plus two bf16 ulps of |y|), with empty
ranks, a row of one position and a row with no valid position (JAX's
uniform softmax over all S slots).

The int8 widening of both dots (a byte permute into the mantissa of 2^23,
one f32 subtract, then bf16 pairs packed from the f32 high halves) is
emulated in numpy over all 256 int8 values, bit-exact; so are the bf16 V
pairs' byte permutes. The shared-memory swizzle of the K and V stages puts
each 8-lane phase's reads on distinct bank groups.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import KVCache as JKVCache
from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops.pallas.decode_attention import decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.decode_attention import (BLOCKS_PER_SM,
                                                     DECODE_ATOL, MIN_STAGES,
                                                     SPLITS, UNIT,
                                                     plan_decode, stage_rows)
from mixq_tpu_torch.kernels.flash_decode import rank_bounds
from mixq_tpu_torch.utils.arith import true_div

BF16_ULP = 2.0 ** -7
SMS = 132
# (n_q, n_kv, head_dim, int8 KV, softcap) of the batch-major paths' heads
SHAPES = {"mistral": (32, 8, 128, True, False),
          "llama-bf16": (32, 32, 128, False, False),
          "gemma2-9b": (16, 8, 256, True, True)}
# cudaOccupancyMaxActiveClusters of kernel 8 for clusters of 1..8 blocks on
# an NVIDIA H100 80GB HBM3 (chip_smoke.py's build phase prints them)
H100_CLUSTERS = {
    "mistral": (528, 264, 163, 124, 94, 79, 69, 62),
    "llama-bf16": (660, 330, 203, 154, 124, 101, 84, 77),
    "gemma2-9b": (528, 264, 163, 124, 94, 79, 69, 62),
}


def t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


def tile_rows(g):
    """The positions of one tile of the kernel's online softmax
    (csrc/decode_attention.cu::tile_rows<G>), emulated below."""
    return 1024 if g <= 2 else 2048 // g


@pytest.mark.parametrize("table", ["h100", "default"])
@pytest.mark.parametrize("B", [1, 8, 16, 64])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_on_served_shapes(shape, B, table):
    n_q, n_kv, D, int8, cap = SHAPES[shape]
    g = n_q // n_kv
    clusters = H100_CLUSTERS[shape] if table == "h100" else None
    fits = clusters or [BLOCKS_PER_SM * SMS // s for s in range(1, 9)]
    tiles = n_kv * B
    for S in (512, 4096, 32768):
        p = plan_decode(B, n_kv, g, S, D, int8, cap, SMS, clusters)
        what = f"{shape} B={B} S={S}: {p}"
        assert p.splits in SPLITS, what
        assert p.blocks == tiles * p.splits, what
        assert p.stage == stage_rows(D) == (64 if D <= 128 else 32), what
        if p.splits > 1:
            # at least MIN_STAGES stages a rank, and every cluster on the
            # card at once
            assert p.splits <= S // (MIN_STAGES * p.stage), what
            assert tiles <= fits[p.splits - 1], what
        if tiles > fits[1]:       # the stripes alone fill the card
            assert p.splits == 1, what


def test_plan_examples():
    """The decode step at B=64 runs one block a stripe on every served
    shape; the B=16 window-sized ring (4096 slots) and generate's B=8
    split their rows (Llama's 256 stripes at B=8 into clusters of 2, which
    the H100 holds all at once with bf16 K/V at 5 blocks an SM)."""
    for shape, (n_q, n_kv, D, int8, cap) in SHAPES.items():
        h100 = H100_CLUSTERS[shape]
        g = n_q // n_kv
        assert plan_decode(64, n_kv, g, 512, D, int8, cap, SMS,
                           h100).splits == 1
        assert plan_decode(8, n_kv, g, 512, D, int8, cap, SMS,
                           h100).splits > 1
    n_q, n_kv, D, int8, cap = SHAPES["mistral"]
    assert plan_decode(16, n_kv, n_q // n_kv, 4096, D, int8, cap, SMS,
                       H100_CLUSTERS["mistral"]).splits > 1


@pytest.mark.parametrize("S,length,start,R", [
    (4096, 4096 + 37, 37, 8), (4096, 3 * 4096 - 5, 2 * 4096 - 5, 4),
    (300, 337, 81, 2), (300, 899, 700, 8), (64, 65, 64, 4),
    (64, 200, 150, 8)])
def test_rank_parts_over_a_ring_past_the_wrap(S, length, start, R):
    """A ring row's valid positions [lo, hi) = [max(start, len - S), len):
    the ranks' parts cover it once, in order, in whole units (the last part
    cut at hi); each part's slots, advanced from its first slot p_lo % S
    with one subtraction of S, are the positions' own slots p % S."""
    lo, hi = max(start, length - S), length
    parts = rank_bounds(lo, hi, UNIT, R)
    assert [p for a, b in parts for p in range(a, b)] == list(range(lo, hi))
    for r, (a, b) in enumerate(parts):
        if a < b:
            assert (a - lo) % UNIT == 0
            assert b == hi or (b - lo) % UNIT == 0
            assert b - a <= S
            slot0 = a % S
            slots = [slot0 + (p - a) for p in range(a, b)]
            slots = [s - S if s >= S else s for s in slots]
            assert slots == [p % S for p in range(a, b)]
        if r:
            assert a == parts[r - 1][1]


def split_recipe(q, k, v, lens, ks, vs, starts, ring, softcap, scale, R,
                 tile):
    """The kernel's arithmetic at R ranks, one (batch row, kv head) at a
    time, on a batch-major layer k, v [B, S, n_kv, D] (int8 with scales
    [B, S, n_kv], or bf16). Returns [B, n_q, D] bf16."""
    B, n_q, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    g = n_q // n_kv
    int8 = ks is not None
    if scale is None:                 # attend's f32 1 / sqrt(D)
        scale = float(1.0 / torch.sqrt(torch.tensor(float(D))))
    out = torch.zeros(B, n_q, D)
    neg_inf = torch.tensor(float("-inf"))
    for b, hk in itertools.product(range(B), range(n_kv)):
        ln, st = int(lens[b]), int(starts[b])
        hi = ln if ring else min(ln, S)
        lo = max(st, 0)
        if ring:
            lo = max(lo, ln - S)
        uniform = hi <= lo
        if uniform:
            lo, hi = 0, S
        qh = q[b, hk * g:(hk + 1) * g].double()
        ranks = []
        for a, e in rank_bounds(lo, hi, UNIT, R):
            m = neg_inf.expand(g).clone()
            l = torch.zeros(g)
            acc = torch.zeros(g, D)
            for t0 in range(a, e, tile):
                pos = torch.arange(t0, min(e, t0 + tile))
                slot = pos % S if ring and not uniform else pos
                # exact products (bf16 x int8 or bf16), an f32 sum
                s = (qh @ k[b, slot, hk].double().T).float() * scale
                if int8:
                    s = s * ks[b, slot, hk]
                if softcap:
                    s = torch.tanh(true_div(s, softcap)) * softcap
                if uniform:
                    s = torch.zeros_like(s)
                mn = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - mn)            # 0 while m = -inf
                m = mn
                p = torch.exp(s - m[:, None])
                l = l * alpha + p.sum(-1)
                pv = p * vs[b, slot, hk] if int8 else p
                p_hi = pv.to(torch.bfloat16).float()
                p_lo = (pv - p_hi).to(torch.bfloat16).float()
                acc = acc * alpha[:, None] + (
                    (p_hi.double() + p_lo.double())
                    @ v[b, slot, hk].double()).float()
            ranks.append((m, l, acc))
        M = torch.stack([m for m, _, _ in ranks]).amax(0)
        lt = torch.zeros(g)
        o = torch.zeros(g, D)
        for m, l, acc in ranks:                      # rank order
            w = torch.where(m == neg_inf, torch.zeros(()), torch.exp(m - M))
            lt = lt + w * l
            o = o + w[:, None] * acc
        out[b, hk * g:(hk + 1) * g] = o / lt[:, None]
    return out.to(torch.bfloat16)


def _beyond(got, ref):
    got = np.asarray(got.float().numpy(), np.float32)
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 0.05
    return (np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)).max()


@pytest.mark.parametrize("int8", [True, False])
def test_split_recipe_vs_pallas(int8):
    """GQA 8/2 heads of 64, ragged lengths (a full row, a row of one
    position), window starts: at R = 1, 2, 4, 8 (a row of one position
    leaves 7 ranks empty at R = 8) and with 16-position tiles."""
    B, S, n_q, n_kv, D = 4, 96, 8, 2, 64
    rng = np.random.default_rng(3 + int8)
    q = jnp.asarray(rng.normal(0, 1, (B, n_q, D)), jnp.bfloat16)
    dt = jnp.int8 if int8 else jnp.bfloat16
    c = JKVCache.create(1, B, S, n_kv, D, dt).update_layer(
        0, jnp.asarray(rng.normal(0, 2, (B, S, n_kv, D)), jnp.float32),
        jnp.asarray(rng.normal(0, 1, (B, S, n_kv, D)), jnp.float32))
    k, v, ks, vs = c.layer_kv(0)
    lens = np.array([S, 50, 1, 77], np.int32)
    starts = np.array([0, 7, 0, 30], np.int32)
    ref = np.asarray(pallas(q, k, v, jnp.asarray(lens), ks, vs,
                            kv_start=jnp.asarray(starts), interpret=True),
                     np.float32)
    g = n_q // n_kv
    for R, tile in itertools.product(SPLITS, (tile_rows(g), 16)):
        got = split_recipe(t(q), t(k), t(v), lens, t(ks), t(vs), starts,
                           False, 0.0, None, R, tile)
        assert _beyond(got, ref) <= DECODE_ATOL, (R, tile)


def _ring_layer(B, S, n_q, n_kv, D, int8, seed, lens):
    """A batch-major layer written through JAX's ring update up to the
    largest length (chunks of 3 across the wraps), and q for each row."""
    rng = np.random.default_rng(seed)
    dt = jnp.int8 if int8 else jnp.bfloat16
    c = JKVCache.create(1, B, S, n_kv, D, dt)
    n = int(max(lens))
    for p0 in range(0, n, 3):
        T = min(3, n - p0)
        c = c.update_layer(
            0, jnp.asarray(rng.normal(0, 1, (B, T, n_kv, D)), jnp.float32),
            jnp.asarray(rng.normal(0, 1, (B, T, n_kv, D)), jnp.float32),
            ring=True)._replace(length=c.length + T)
    q = jnp.asarray(rng.normal(0, 1.5, (B, n_q, D)), jnp.bfloat16)
    return (q,) + tuple(c.layer_kv(0))


@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("case", ["ring_window", "softcap_scale", "uniform"])
def test_split_recipe_vs_attend(int8, case):
    """Against JAX's attend over the same cache, one row at a time: a
    32-slot ring read past its wrap (lengths 45 and 70) and before it (20)
    from window starts max(start, len - 24); gemma2's scale and a softcap
    that binds; a row whose start is its length (no valid position: the
    uniform softmax over all S slots), on the ring and off it."""
    B, S, n_q, n_kv, D = 3, 32, 8, 2, 32
    lens = np.array([45, 70, 20], np.int32)
    start = np.array([0, 50, 2], np.int32)
    ring, W, scale, cap = True, 24, None, 0.0
    if case == "softcap_scale":
        scale, cap, W = 24.0 ** -0.5, 0.5, None
    if case == "uniform":
        start = np.array([45, 3, 20], np.int32)
        W = None
    q, k, v, ks, vs = _ring_layer(B, S, n_q, n_kv, D, int8, 7 + int8, lens)
    los = start if W is None else np.maximum(start, lens - W)
    for b in range(B):
        sl = slice(b, b + 1)
        ref = np.asarray(j_attend(
            q[sl, None], k[sl], v[sl], jnp.asarray([lens[b] - 1]),
            jnp.asarray(lens[b]), jnp.asarray(start[sl]), sliding_window=W,
            k_scale=None if ks is None else ks[sl],
            v_scale=None if vs is None else vs[sl], scale=scale,
            softcap=cap or None, ring=ring)[:, 0], np.float32)
        for R, tile in itertools.product(SPLITS, (tile_rows(n_q // n_kv),
                                                  16)):
            got = split_recipe(t(q[sl]), t(k[sl]), t(v[sl]), lens[sl],
                               t(None if ks is None else ks[sl]),
                               t(None if vs is None else vs[sl]), los[sl],
                               ring, cap, scale, R, tile)
            assert _beyond(got, ref) <= DECODE_ATOL, (b, R, tile)


def byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s) (selector nibbles 0-7)."""
    src = [(x >> (8 * i)) & 0xff for i in range(4)] + [
        (y >> (8 * i)) & 0xff for i in range(4)]
    return sum(src[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def f32(bits):
    return np.array([bits], np.uint32).view(np.float32)[0]


def bits(x):
    return int(np.array([x], np.float32).view(np.uint32)[0])


def s8_f32(x, byte):
    """csrc/decode_attention.cu::s8_f32: byte `byte` of x = w ^ 0x80808080
    in the mantissa of 2^23, less 2^23 + 128, in f32."""
    return f32(byte_perm(x, 0x4B000000, 0x7440 | byte)) - np.float32(8388736)


def hi_halves(lo, hi):
    """csrc/decode_attention.cu::hi_halves: the bf16 pair of two f32's high
    halves, as the two values it holds."""
    pair = byte_perm(bits(lo), bits(hi), 0x7632)
    return f32((pair & 0xffff) << 16), f32(pair & 0xffff0000)


def test_int8_widening_is_exact_for_every_value():
    """The kernel's int8 widening on all 256 int8 values, four to a word:
    each byte in f32 is its value, and the bf16 pairs made of the f32 high
    halves hold the values exactly: K's pairs (bytes 0, 1 and 2, 3 of one
    row's word) and V's (byte `by` of two rows' words)."""
    vals = np.arange(-128, 128, dtype=np.int8)
    words = vals.view(np.uint8).reshape(64, 4)
    word = [int(w[0]) | int(w[1]) << 8 | int(w[2]) << 16 | int(w[3]) << 24
            for w in words]
    v4s = vals.reshape(64, 4)
    for w, v4 in zip(word, v4s):
        x = w ^ 0x80808080
        f = [s8_f32(x, i) for i in range(4)]
        assert [float(a) for a in f] == [float(a) for a in v4]
        assert hi_halves(f[0], f[1]) == (v4[0], v4[1])
        assert hi_halves(f[2], f[3]) == (v4[2], v4[3])
    for (w0, v0), (w1, v1) in zip(zip(word, v4s), zip(word[1:], v4s[1:])):
        x0, x1 = w0 ^ 0x80808080, w1 ^ 0x80808080
        for by in range(4):
            assert hi_halves(s8_f32(x0, by), s8_f32(x1, by)) == (v0[by],
                                                                 v1[by])


def test_bf16_pairs_of_two_positions():
    """The bf16 V fragments: __byte_perm(w0, w1, 0x5410) pairs the low
    halves (head-dim value d of positions 0 and 1), 0x7632 the high halves
    (d + 1)."""
    w0, w1 = 0xAAAA1111, 0xBBBB2222
    assert byte_perm(w0, w1, 0x5410) == 0x22221111
    assert byte_perm(w0, w1, 0x7632) == 0xBBBBAAAA


def swz(r, c, chunks):
    """csrc/decode_attention.cu::swz."""
    return c ^ (((r & 1) << 2) ^ (((r >> 2) & 3) << 1)) if chunks >= 8 else c


@pytest.mark.parametrize("chunks", [8, 16, 32])
def test_swizzle_spreads_each_phase_over_the_banks(chunks):
    """Each row's chunks stay a permutation of the row; an 8-lane phase's
    K reads (rows 2h, 2h+1 of an 8-row group, chunks 4i + t) and V reads
    (rows 4t + k of a 16-row group, chunks 2h, 2h+1 of a lane pair) land on
    8 distinct 16-byte bank groups (offsets mod 128 bytes)."""
    for r in range(32):
        assert sorted(swz(r, c, chunks) for c in range(chunks)) == list(
            range(chunks))
    for base, h, i in itertools.product((0, 8, 16), range(4), range(
            chunks // 4)):
        phase = {swz(base + 2 * h + jj, 4 * i + tt, chunks) % 8
                 for jj in (0, 1) for tt in range(4)}
        assert len(phase) == 8
    for base, k, h, c0 in itertools.product((0, 16, 32), range(4), range(4),
                                            (0, 8)):
        if c0 + 2 * h + 1 >= chunks:
            continue
        phase = {swz(base + 4 * tt + k, c0 + 2 * h + jj, chunks) % 8
                 for jj in (0, 1) for tt in range(4)}
        assert len(phase) == 8
