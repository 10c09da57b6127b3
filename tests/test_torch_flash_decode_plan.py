"""PyTorch port, kernel 3's launch plan and its cluster split on the CPU.

`kernels/flash_decode.py::plan_flash` on the served shapes (Llama-2-7B's
32/32 heads of 128, the GQA 32/8 heads of Mistral-7B, Gemma-2-9B's 16/8
heads of 256 with the softcap, Gemma-2-27B's 32/16 heads of 128 with it),
int8 and bf16 KV, B = 1, 8, 64 and S = 128, 640, 4096, on 132 SMs with
the H100's cluster occupancy and with the default one: R one of 1, 2, 4,
8, at least MIN_STEPS block steps a rank, the block's shared memory within
what a launch takes, every cluster on the card at once, and R = 1
wherever the (kv head, batch row) stripes alone fill the card.

`rank_bounds` (csrc/cluster.cuh::rank_part): each rank's part of a row's
valid slots [start, length) covers it exactly once, in order, in whole
warp steps, on ragged rows, at length 1, at length <= start and with more
ranks than warp steps.

The kernel's split recipe, emulated in PyTorch: each rank's scores over
its part (int8: the exact int32 dot, then q_scale, k_scale and the scale;
the cap), the cluster max, p = exp(s - m) and each rank's sum, l the ranks'
sums added in rank order, the cluster max of p * v_scale, p_i8 on each
part and each rank's int32 p . v added in rank order (bf16: f32 partials of
bf16(p) . v). Held against the Pallas flash_decode_attention(
interpret=True) at R = 1, 2, 4 and 8 within tests/test_torch_flash_decode.py's
limit (two bf16 ulps of |y| plus ATOL), int8 and bf16, with and without
the softcap; the int32 p . v is bit-equal across R.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.flash_decode import flash_decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.flash_decode import (LAUNCH_SMEM, MIN_STEPS,
                                                 SPLITS, WARPS,
                                                 part_rows, plan_flash,
                                                 rank_bounds, rows_per_step,
                                                 smem_bytes, unroll,
                                                 uses_ring)

BF16_ULP = 2.0 ** -7
ATOL = {True: 8e-3, False: 5e-4}                 # int8, bf16 KV
SMS = 132
# (n_q, n_kv, head_dim, softcap) of the served models' attention
SHAPES = {"llama": (32, 32, 128, False), "gqa": (32, 8, 128, False),
          "gemma2-9b": (16, 8, 256, True), "gemma2-27b": (32, 16, 128, True)}
# cudaOccupancyMaxActiveClusters of kernel 3 for clusters of 1..8 blocks on
# an NVIDIA H100 80GB HBM3, by (shape, int8, S) (chip_smoke.py's build
# phase prints them)
H100_CLUSTERS = {
    ("llama", True, 128): (1056, 528, 327, 248, 193, 163, 139, 124),
    ("llama", True, 640): (1056, 528, 327, 248, 193, 163, 139, 124),
    ("llama", True, 4096): (528, 528, 327, 248, 193, 163, 139, 124),
    ("gqa", True, 128): (660, 330, 203, 154, 124, 101, 84, 77),
    ("gqa", True, 640): (660, 330, 203, 154, 124, 101, 84, 77),
    ("gqa", True, 4096): (132, 198, 124, 124, 94, 101, 84, 77),
    ("gemma2-9b", True, 128): (660, 330, 203, 154, 124, 101, 84, 77),
    ("gemma2-9b", True, 640): (660, 330, 203, 154, 124, 101, 84, 77),
    ("gemma2-9b", True, 4096): (396, 330, 203, 154, 124, 101, 84, 77),
    ("gemma2-27b", True, 128): (660, 330, 203, 154, 124, 101, 84, 77),
    ("gemma2-27b", True, 640): (660, 330, 203, 154, 124, 101, 84, 77),
    ("gemma2-27b", True, 4096): (396, 330, 203, 154, 124, 101, 84, 77),
    ("llama", False, 128): (1056, 528, 327, 248, 193, 163, 139, 124),
    ("llama", False, 640): (1056, 528, 327, 248, 193, 163, 139, 124),
    ("llama", False, 4096): (792, 528, 327, 248, 193, 163, 139, 124),
    ("gqa", False, 128): (792, 396, 248, 186, 146, 124, 101, 92),
    ("gqa", False, 640): (792, 396, 248, 186, 146, 124, 101, 92),
    ("gqa", False, 4096): (264, 198, 163, 154, 124, 101, 101, 92),
    ("gemma2-9b", False, 128): (924, 528, 327, 248, 193, 163, 139, 124),
    ("gemma2-9b", False, 640): (792, 462, 287, 216, 171, 163, 139, 124),
    ("gemma2-9b", False, 4096): (396, 330, 203, 186, 146, 124, 124, 107),
    ("gemma2-27b", False, 128): (1056, 528, 327, 248, 193, 163, 139, 124),
    ("gemma2-27b", False, 640): (1056, 528, 327, 248, 193, 163, 139, 124),
    ("gemma2-27b", False, 4096): (528, 330, 248, 216, 171, 163, 139, 124),
}


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("table", ["h100", "default"])
@pytest.mark.parametrize("B", [1, 8, 64])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_on_served_shapes(shape, B, table):
    n_q, n_kv, D, _ = SHAPES[shape]
    g = n_q // n_kv
    for S, int8 in itertools.product((128, 640, 4096), (True, False)):
        clusters = (H100_CLUSTERS[(shape, int8, S)] if table == "h100"
                    else None)
        p = plan_flash(B, n_kv, g, S, D, int8, SMS, clusters)
        esize = 1 if int8 else 2
        step = WARPS * rows_per_step(D, esize) * unroll(uses_ring(g, int8))
        fits = clusters or [8 * SMS // s for s in range(1, 9)]
        tiles = n_kv * B
        what = f"{shape} B={B} S={S} int8={int8}: {p}"
        assert p.splits in SPLITS, what
        assert p.blocks == tiles * p.splits and p.step == step, what
        assert p.smem == smem_bytes(g, S, D, esize, p.splits), what
        assert p.smem <= LAUNCH_SMEM, what
        if p.splits > 1:
            # at least MIN_STEPS block steps a rank, and every cluster on
            # the card at once
            assert p.splits <= S // (MIN_STEPS * step), what
            assert tiles <= fits[p.splits - 1], what
        if tiles > fits[1]:       # the stripes alone fill the card
            assert p.splits == 1, what


def test_plan_examples():
    """The decode step at B=64 (every served shape: the stripes fill the
    card) runs one block a stripe; a small batch splits its rows as far as
    its clusters all fit on the card at once and each rank walks at least
    MIN_STEPS block steps."""
    for shape, (n_q, n_kv, D, _) in SHAPES.items():
        clusters = H100_CLUSTERS[(shape, True, 640)]
        assert plan_flash(64, n_kv, n_q // n_kv, 640, D, True, SMS,
                          clusters).splits == 1
    n_q, n_kv, D, _ = SHAPES["gemma2-9b"]
    assert plan_flash(8, n_kv, n_q // n_kv, 640, D, True, SMS,
                      H100_CLUSTERS[("gemma2-9b", True, 640)]).splits == 4
    n_q, n_kv, D, _ = SHAPES["gqa"]
    assert plan_flash(8, n_kv, n_q // n_kv, 640, D, True, SMS,
                      H100_CLUSTERS[("gqa", True, 640)]).splits == 4
    n_q, n_kv, D, _ = SHAPES["gemma2-9b"]
    assert plan_flash(8, n_kv, n_q // n_kv, 640, D, False, SMS,
                      H100_CLUSTERS[("gemma2-9b", False, 640)]).splits == 8
    n_q, n_kv, D, _ = SHAPES["llama"]
    assert plan_flash(1, n_kv, n_q // n_kv, 640, D, True, SMS,
                      H100_CLUSTERS[("llama", True, 640)]).splits == 2


@pytest.mark.parametrize("start,length,unit,R", [
    (0, 512, 4, 1), (0, 512, 4, 4), (5, 300, 4, 8), (31, 290, 8, 2),
    (3, 9, 1, 8), (0, 1, 4, 4), (0, 1, 32, 8), (9, 9, 4, 2), (12, 3, 4, 4),
    (0, 0, 2, 8), (7, 13, 4, 8), (0, 4096, 2, 8)])
def test_rank_bounds_cover_the_row_once(start, length, unit, R):
    parts = rank_bounds(start, length, unit, R)
    assert len(parts) == R
    covered = [s for a, b in parts for s in range(a, b)]
    assert covered == list(range(start, length))
    for r, (a, b) in enumerate(parts):
        assert a <= b
        if a < b:                             # whole warp steps
            assert (a - start) % unit == 0
            assert b == length or (b - start) % unit == 0
        if r:
            assert a == parts[r - 1][1]       # contiguous, in rank order
    if start == 0:                            # each part fits its scores
        assert all(b - a <= part_rows(length, unit, R) for a, b in parts)


def split_recipe(q, k, v, lengths, ks, vs, starts, softcap, scale, R, unit):
    """The kernel's arithmetic at R ranks, one (batch row, kv head) at a
    time: returns (out [B, n_q, D] bf16, the int8 mode's summed int32 p . v
    [B, n_kv, g, D] as int64, or None)."""
    B, n_q, D = q.shape
    n_kv, _, S, _ = k.shape
    g = n_q // n_kv
    int8 = ks is not None
    qf = q.float().reshape(B, n_kv, g, D)
    if int8:
        q_scale = torch.clamp_min(qf.abs().amax(-1, keepdim=True) / 127.0,
                                  1e-8)
        q_i8 = torch.clamp(torch.round(qf / q_scale), -127, 127)
    out = torch.zeros(B, n_kv, g, D)
    pv_all = torch.zeros(B, n_kv, g, D, dtype=torch.int64)
    for b, hk in itertools.product(range(B), range(n_kv)):
        ln, st = min(int(lengths[b]), S), max(int(starts[b]), 0)
        if ln <= st:
            continue                                  # zeros
        parts = [(a, e) for a, e in rank_bounds(st, ln, unit, R)]
        scores = []
        for a, e in parts:
            kk = k[hk, b, a:e]
            if int8:
                dot = (q_i8[b, hk].double() @ kk.double().T).float()
                s = dot * q_scale[b, hk] * ks[hk, b, a:e] * scale
            else:
                s = (qf[b, hk] @ kk.float().T) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            scores.append(s)                          # [g, part]
        m = torch.stack([s.amax(-1) if s.shape[-1] else
                         torch.full((g,), -torch.inf) for s in scores]
                        ).amax(0)
        ps = [torch.exp(s - m[:, None]) for s in scores]
        l = torch.zeros(g)
        for p in ps:                                  # rank order, in f32
            l = l + p.sum(-1)
        if int8:
            p2s = [p * vs[hk, b, a:e] for p, (a, e) in zip(ps, parts)]
            pmax = torch.stack([p2.amax(-1) if p2.shape[-1] else
                                torch.zeros(g) for p2 in p2s]).amax(0)
            p_scale = torch.clamp_min(pmax / 127.0, 1e-20)
            pv = torch.zeros(g, D, dtype=torch.int64)
            for p2, (a, e) in zip(p2s, parts):        # exact int32 partials
                p_i8 = torch.round(p2 / p_scale[:, None])
                pv += (p_i8.double() @ v[hk, b, a:e].double()).long()
            pv_all[b, hk] = pv
            out[b, hk] = pv.float() * p_scale[:, None] / l[:, None]
        else:
            pv = torch.zeros(g, D)
            for p, (a, e) in zip(ps, parts):          # rank order
                pv = pv + p.to(torch.bfloat16).float() @ v[hk, b, a:e].float()
            out[b, hk] = pv / l[:, None]
    return (out.reshape(B, n_q, D).to(torch.bfloat16),
            pv_all if int8 else None)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("int8", [True, False])
def test_split_recipe_vs_pallas(int8, softcap):
    """gemma2-style heads cut to 4 q / 2 kv of 64 (so 8 rows a warp step
    in int8, 4 in bf16), ragged lengths with a row of one slot, a row of
    none and a window start; with the softcap q is scaled so that the cap
    of 50 binds."""
    B, S, nq, nkv, D = 4, 128, 4, 2, 64
    rng = np.random.default_rng(int8 + int(softcap))
    gain = 8.0 if softcap else 1.0
    q = jnp.asarray(rng.normal(0, gain, (B, nq, D)), jnp.bfloat16)
    kf = rng.normal(0, 1, (1, nkv, B, S, D)).astype(np.float32)
    vf = rng.normal(0, 1, (1, nkv, B, S, D)).astype(np.float32)
    if int8:
        k, ks = JQ.quantize_kv(jnp.asarray(kf))
        v, vs = JQ.quantize_kv(jnp.asarray(vf))
    else:
        k, v = jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16)
        ks = vs = None
    lengths = np.array([S, 97, 1, 40], np.int32)
    starts = np.array([0, 5, 0, 40], np.int32)
    scale = 24.0 ** -0.5
    ref = np.asarray(pallas(q, k, v, jnp.asarray(lengths), ks, vs,
                            kv_start=jnp.asarray(starts), layer=0,
                            interpret=True, softcap=softcap, scale=scale),
                     np.float32)
    ref[3] = 0.0           # a row with no valid slot: zeros in the port
    tq, tk, tv = t(q), t(k)[0], t(v)[0]
    tks = None if ks is None else t(ks)[0]
    tvs = None if vs is None else t(vs)[0]
    unit = rows_per_step(D, 1 if int8 else 2)
    pvs = []
    for R in SPLITS:
        got, pv = split_recipe(tq, tk, tv, lengths, tks, tvs, starts,
                               softcap, scale, R, unit)
        got = got.float().numpy()
        beyond = (np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)).max()
        assert beyond <= ATOL[int8], (R, beyond)
        assert (got[3] == 0).all()
        pvs.append(pv)
    if int8:
        assert all(torch.equal(pvs[0], pv) for pv in pvs[1:])
        assert pvs[0].abs().max() > 0
