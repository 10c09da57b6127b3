"""PyTorch port, kernels 3 and 8 (kernels/flash_decode.py,
kernels/decode_attention.py) at groups past 8 query heads a kv head, on the
CPU: their plain versions against the Pallas kernels they port
(flash_decode_attention(..., interpret=True), decode_attention(...,
interpret=True)), which take any group, at StarCoder2-7B's g = 9,
StarCoder2-3B's 12, ChatGLM3-6B's 16 and Falcon-7B's 71 (D = 64, one kv
head), int8 and bf16 KV, and with falcon's ALiBi slopes (pre-scaled by
1/sqrt(head_dim), models.layers.falcon_alibi_slopes).

- Kernel 3's plain version over a stacked head-major cache, per-row
  lengths 0, 1, S and ragged ones with first valid slots: two bf16 ulps of
  |y| plus 8e-3 (int8) / 5e-4 (bf16) on a spread softmax, as
  tests/test_torch_attention_groups.py holds the groups up to 8; with
  falcon's slopes, within 3 probability levels of a row (the ALiBi bias
  peaks the softmax; flash_decode_level, as tests/test_torch_alibi.py).
- Kernel 8's plain version over the batch-major cache: within one bf16
  ulp of |y| of the Pallas kernel plus 2^-20, bit-equal in 99% of the
  outputs; with falcon's slopes, `attend`'s recipe against JAX's `attend`
  within one bf16 ulp plus 2^-20.
- falcon's slopes bit-equal to JAX's alibi_slopes / sqrt(f32(head_dim)).
- The head tiles the CUDA kernels run (head_tile) and their plans: the
  grid holds T tiles per (kv head, row); a tile's shared memory is its
  G <= 8 heads'; no softcap past 8 (the card refuses it;
  tests/test_torch_gpu.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import alibi_slopes as j_alibi_slopes
from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops.pallas.decode_attention import \
    decode_attention as pallas_decode
from mixq_tpu.ops.pallas.flash_decode import \
    flash_decode_attention as pallas_flash
from mixq_tpu_torch.kernels import decode_attention as DA
from mixq_tpu_torch.kernels import flash_decode as FD
from mixq_tpu_torch.models.layers import falcon_alibi_slopes

from test_torch_attention_groups import (ATOL, BF16_ULP, batch_major_case,
                                         beyond_two_ulps, head_major_case, t)

# (n_q, n_kv, D): StarCoder2-7B's 36/4 as 9/1, StarCoder2-3B's 24/2 as
# 12/1, ChatGLM3-6B's 32/2, Falcon-7B's 71/1 at D = 64
SHAPES = [(9, 1, 128), (12, 1, 64), (32, 2, 64), (71, 1, 64)]
# probability levels of a row within which the plain version stays of the
# Pallas kernel on a peaked (ALiBi) softmax (tests/test_torch_alibi.py)
PEAK_LEVELS = 3.0


def falcon_slopes(nq, D):
    """JAX's falcon slopes (mixq_tpu/models/decoder.py:489-494)."""
    return j_alibi_slopes(nq) / jnp.sqrt(jnp.float32(D))


def test_falcon_slopes_bit_equal_to_jax():
    for nq, D in ((71, 64), (6, 16), (128, 64)):
        got = falcon_alibi_slopes(nq, D, torch.device("cpu")).numpy()
        np.testing.assert_array_equal(got, np.asarray(falcon_slopes(nq, D)))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D", SHAPES)
def test_flash_plain_vs_pallas(nq, nkv, D, int8):
    B, S = 4, 160
    q, k, v, ks, vs = head_major_case(B, S, nq, nkv, D, int8,
                                      seed=nq * 7 + D + int8)
    lengths = np.array([S, 1, 0, 97], np.int32)
    start = np.array([0, 0, 0, 13], np.int32)
    ref = pallas_flash(q, k, v, jnp.asarray(lengths), ks, vs,
                       kv_start=jnp.asarray(start), layer=1, interpret=True)
    got = FD.flash_decode_attention(t(q), t(k), t(v), t(lengths), t(ks),
                                    t(vs), kv_start=t(start), layer=1)
    assert got.dtype == torch.bfloat16 and got.shape == (B, nq, D)
    ref = np.asarray(ref, np.float32)
    assert beyond_two_ulps(got.float().numpy(), ref) <= ATOL[int8]
    assert (got[2] == 0).all() and np.abs(ref).max() > 0.1


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D", [(71, 1, 64), (9, 1, 128)])
def test_flash_plain_falcon_alibi_vs_pallas(nq, nkv, D, int8):
    B, S = 3, 200
    q, k, v, ks, vs = head_major_case(B, S, nq, nkv, D, int8, seed=nq + D)
    lengths = np.array([S, 130, 1], np.int32)
    start = np.array([0, 9, 0], np.int32)
    sl = falcon_slopes(nq, D)
    ref = np.asarray(pallas_flash(q, k, v, jnp.asarray(lengths), ks, vs,
                                  kv_start=jnp.asarray(start), layer=0,
                                  alibi_slopes=sl, interpret=True),
                     np.float32)
    slopes = falcon_alibi_slopes(nq, D, torch.device("cpu"))
    args = (t(q), t(k), t(v), t(lengths), t(ks), t(vs), t(start), 0)
    got = FD.flash_decode_attention(*args, alibi_slopes=slopes)
    got = got.float().numpy()
    level = FD.flash_decode_level(*args, alibi_slopes=slopes).numpy()
    over = np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)
    assert float((over.max(-1) / level).max()) <= PEAK_LEVELS
    free = FD.flash_decode_plain(*args).float().numpy()
    assert np.abs(free - ref).max() > 1e-2


@pytest.mark.parametrize("kv_dtype", [jnp.bfloat16, jnp.int8])
@pytest.mark.parametrize("nq,nkv,D", SHAPES)
def test_decode_plain_vs_pallas(nq, nkv, D, kv_dtype):
    B, S = 3, 48
    q, k, v, ks, vs = batch_major_case(B, S, nq, nkv, D, kv_dtype,
                                       seed=nq + D)
    kv_len = jnp.asarray([S, 1, 30], jnp.int32)
    kv_start = jnp.asarray([0, 0, 7], jnp.int32)
    ref = np.asarray(pallas_decode(q, k, v, kv_len, ks, vs, kv_start,
                                   interpret=True), np.float32)
    got = DA.decode_attention(t(q), t(k), t(v), t(kv_len), t(ks), t(vs),
                              t(kv_start)).float().numpy()
    assert got.shape == (B, nq, D) and np.abs(ref).max() > 0.05
    tol = BF16_ULP * np.abs(ref) + 2.0 ** -20
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()
    assert (got == ref).mean() > 0.99


@pytest.mark.parametrize("kv_dtype", [jnp.bfloat16, jnp.int8])
def test_decode_plain_falcon_alibi_vs_attend(kv_dtype):
    """Falcon-7B's 71 heads on one kv head, D = 64, with its slopes:
    kernel 8's plain version against JAX's `attend` at T = 1."""
    B, S, nq, nkv, D = 3, 40, 71, 1, 64
    q, k, v, ks, vs = batch_major_case(B, S, nq, nkv, D, kv_dtype, seed=71)
    lens = np.array([S, 23, 9], np.int32)
    starts = np.array([0, 4, 0], np.int32)
    ref = np.asarray(j_attend(
        q[:, None], k, v, jnp.asarray(lens - 1)[:, None], jnp.asarray(lens),
        jnp.asarray(starts), k_scale=ks, v_scale=vs,
        alibi=falcon_slopes(nq, D))[:, 0], np.float32)
    slopes = falcon_alibi_slopes(nq, D, torch.device("cpu"))
    got = DA.decode_attention(t(q), t(k), t(v), t(lens), t(ks), t(vs),
                              t(starts), alibi_slopes=slopes)
    got = got.float().numpy()
    assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 2.0 ** -20).all()
    free = DA.decode_attention(t(q), t(k), t(v), t(lens), t(ks), t(vs),
                               t(starts)).float().numpy()
    assert np.abs(free - ref).max() > 1e-2


@pytest.mark.parametrize("g", [9, 12, 16, 36, 71])
def test_head_tiles_and_plans(g):
    T, G = FD.head_tile(g)
    assert G <= FD.MAX_TILE and T * G >= g > (T - 1) * G
    # the CUDA kernels keep the instantiations of G <= 4 untiled at
    # compile time: a tiled group's tiles have 5 heads or more
    assert all(FD.head_tile(n)[0] == 1 or FD.head_tile(n)[1] >= 5
               for n in range(1, 257))
    assert (T - 1) * FD.MAX_TILE < g <= T * FD.MAX_TILE
    for int8 in (True, False):
        esize = 1 if int8 else 2
        for B in (8, 64):
            plan = FD.plan_flash(B, 1, g, 640, 64, int8, 132)
            assert plan.blocks == T * B * plan.splits
            assert plan.smem == FD.smem_bytes(G, 640, 64, esize,
                                              plan.splits)
            assert plan.smem <= FD.LAUNCH_SMEM
            dplan = DA.plan_decode(B, 1, g, 640, 64, int8, False, 132)
            assert dplan.blocks == T * B * dplan.splits
    # the tiles fill the card with fewer rows: more blocks than a g <= 8
    # group's at the same stripes
    assert (FD.plan_flash(8, 1, 71, 640, 64, True, 132).blocks
            > FD.plan_flash(8, 1, 8, 640, 64, True, 132).blocks)
    modes = dict.fromkeys(FD.SHAPE_MODES, 0)
    FD.count_shape_modes(modes, g, 64)
    assert modes["tiled"] == 1
    assert sum(modes.values()) == 1 + (G in FD.GROUP_MODES)
