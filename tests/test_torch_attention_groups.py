"""PyTorch port, kernels 3 and 8 (kernels/flash_decode.py,
kernels/decode_attention.py) at the RMSNorm families' GQA groups g = 3, 5,
6, 7 and at head dim 96, on the CPU: their plain versions against the
Pallas kernels they port, flash_decode_attention(..., interpret=True) and
decode_attention(..., interpret=True), which take these shapes.

- Kernel 3's plain version over a stacked head-major cache read at a layer
  index, bf16 and int8 (per-(token, head) scales padded to a multiple of
  128 as the cache allocates them), per-row lengths 0, 1, S and ragged ones
  with first valid slots (kv_start); gemma2's softcap and score scale at
  head dim 96, the one new shape the CUDA kernel takes a softcap at (its
  new groups come without one). Held as tests/test_torch_flash_decode.py
  holds the power-of-two groups: two bf16 ulps of |y| plus ATOL.
- Kernel 8's plain version over the batch-major cache, bf16 and int8,
  per-row lengths (one of 1, one of S) and starts: within one bf16 ulp of
  |y| of the Pallas kernel plus 2^-20 (both sides round an f32 sum taken
  in another order, so an output that cancels to near zero keeps a few
  f32 ulps of the sum of |p v|), and bit-equal in 99% of the outputs.
- The shapes the kernels take: groups 1-8, rows of 16-512 bytes that are
  a power of two of 16-byte chunks or 96 / 192 bytes; a row of 96 bytes
  spreads over 8 lanes (6 of them on its chunks), 192 over 16; the
  launch plans and shared memory at Qwen2.5-7B's and Phi-3's heads; the
  policy sends Phi-3 and Qwen2.5-7B with int8 KV to the head-major cache
  under "flash" and bf16 KV to the batch-major one under "auto"; both
  wrappers refuse a softcap at a group that is not a power of two on the
  card (tests/test_torch_gpu.py), never on the CPU, whose plain versions
  take it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import KVCache as JKVCache
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.decode_attention import \
    decode_attention as pallas_decode
from mixq_tpu.ops.pallas.flash_decode import \
    flash_decode_attention as pallas_flash
from mixq_tpu_torch import presets
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels import decode_attention as DA
from mixq_tpu_torch.kernels import flash_decode as FD

BF16_ULP = 2.0 ** -7
ATOL = {True: 8e-3, False: 5e-4}                 # int8, bf16 KV
# (n_q, n_kv, D): Qwen2/2.5-7B's g = 7, Qwen2.5-14B's 5, Qwen2-1.5B's 6,
# Phi-4-mini's 3 (at small widths), Phi-3's D = 96 (MHA), g = 7 at D = 96
SHAPES = [(7, 1, 128), (10, 2, 64), (6, 1, 128), (6, 2, 64), (2, 2, 96),
          (7, 1, 96)]


def t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


def beyond_two_ulps(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float((np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)).max())


def head_major_case(B, S, nq, nkv, D, int8, seed, L=2):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(0, 1, (B, nq, D)), jnp.bfloat16)
    k = rng.normal(0, 1, (L, nkv, B, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (L, nkv, B, S, D)).astype(np.float32)
    if not int8:
        return (q, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                None, None)
    kq, ks = JQ.quantize_kv(jnp.asarray(k))
    vq, vs = JQ.quantize_kv(jnp.asarray(v))
    pad = ((0, 0),) * 3 + ((0, -(-S // 128) * 128 - S),)
    return (q, kq, vq, jnp.pad(ks, pad, constant_values=1.0),
            jnp.pad(vs, pad, constant_values=1.0))


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
@pytest.mark.parametrize("nq,nkv", [(4, 2), (2, 2)])
def test_flash_softcap_and_scale_at_head_dim_96(nq, nkv, int8):
    """q and K shifted by 2 so the scores reach the cap of 30 (as
    tests/test_torch_gpu.py's softcap case), a score scale of 1/sqrt(80)."""
    B, S, D, cap = 3, 200, 96, 30.0
    q, k, v, ks, vs = head_major_case(B, S, nq, nkv, D, int8, seed=nq + 96)
    if not int8:
        k = (k.astype(jnp.float32) + 2.0).astype(jnp.bfloat16)
    else:
        kq, kss = JQ.quantize_kv(jnp.asarray(
            np.random.default_rng(5).normal(2.0, 1.0, (2, nkv, B, S, D)),
            jnp.float32))
        pad = ((0, 0),) * 3 + ((0, 256 - S),)
        k, ks = kq, jnp.pad(kss, pad, constant_values=1.0)
    q = (q.astype(jnp.float32) + 2.0).astype(jnp.bfloat16)
    lengths = np.array([S, 120, 1], np.int32)
    start = np.array([0, 40, 0], np.int32)
    kw = dict(softcap=cap, scale=80.0 ** -0.5)
    ref = pallas_flash(q, k, v, jnp.asarray(lengths), ks, vs,
                       kv_start=jnp.asarray(start), layer=0, interpret=True,
                       **kw)
    got = FD.flash_decode_attention(t(q), t(k), t(v), t(lengths), t(ks),
                                    t(vs), kv_start=t(start), layer=0, **kw)
    assert beyond_two_ulps(got.float().numpy(), ref) <= ATOL[int8]
    uncapped = FD.flash_decode_attention(t(q), t(k), t(v), t(lengths),
                                         t(ks), t(vs), kv_start=t(start),
                                         layer=0, scale=kw["scale"])
    assert (uncapped - got).abs().max().item() > 10 * ATOL[int8]


def batch_major_case(B, S, nq, nkv, D, kv_dtype, seed):
    ks_ = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks_[0], (B, nq, D)).astype(jnp.bfloat16)
    k_raw = jax.random.normal(ks_[1], (B, S, nkv, D)) * 2.0
    v_raw = jax.random.normal(ks_[2], (B, S, nkv, D))
    c = JKVCache.create(1, B, S, nkv, D, kv_dtype).update_layer(0, k_raw,
                                                                v_raw)
    return (q,) + tuple(c.layer_kv(0))


@pytest.mark.parametrize("kv_dtype", [jnp.bfloat16, jnp.int8])
@pytest.mark.parametrize("nq,nkv,D", SHAPES)
def test_decode_plain_vs_pallas(nq, nkv, D, kv_dtype):
    B, S = 3, 48
    q, k, v, ks, vs = batch_major_case(B, S, nq, nkv, D, kv_dtype,
                                       seed=nq + D)
    for kv_len, kv_start in ((jnp.asarray([S, 1, 30], jnp.int32),
                              jnp.asarray([0, 0, 7], jnp.int32)),
                             (S - 5, None)):
        ref = np.asarray(pallas_decode(q, k, v, kv_len, ks, vs, kv_start,
                                       interpret=True), np.float32)
        got = DA.decode_attention(
            t(q), t(k), t(v), kv_len if isinstance(kv_len, int)
            else t(kv_len), t(ks), t(vs), None if kv_start is None
            else t(kv_start)).float().numpy()
        assert got.shape == (B, nq, D) and np.abs(ref).max() > 0.05
        # one bf16 ulp of |y| plus a few f32 ulps of the sum of |p v|
        # (<= max|v|, ~4 here): both sides round an f32 sum taken in
        # another order, and an output that cancels to near zero keeps
        # the sum's absolute error
        tol = BF16_ULP * np.abs(ref) + 2.0 ** -20
        assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()
        assert (got == ref).mean() > 0.99


def test_shapes_the_kernels_take():
    assert FD.GROUPS == (1, 2, 3, 4, 5, 6, 7, 8)
    assert FD.SOFTCAP_GROUPS == (1, 2, 4, 8)
    assert DA.GROUPS is FD.GROUPS and DA.ROW_BYTES is FD.ROW_BYTES
    # lanes a row and rows a warp step: 96 bytes on 8 lanes, 192 on 16
    assert [FD.row_lanes(b) for b in (16, 64, 96, 128, 192, 256, 512)] == [
        1, 4, 8, 8, 16, 16, 32]
    assert FD.rows_per_step(96, 1) == FD.rows_per_step(128, 1) == 4
    assert FD.rows_per_step(96, 2) == FD.rows_per_step(128, 2) == 2
    assert DA.stage_rows(96) == DA.stage_rows(128) == 64
    for g in FD.GROUPS:
        assert FD.flash_decode_supported(g, 640, 96, 1)
        assert FD.flash_decode_supported(g, 640, 96, 2)
    # a group past 8 runs in head tiles of at most 8 (Falcon-7B's 71 heads
    # on one kv head, StarCoder2's 9, ChatGLM3's 16)
    assert FD.MAX_TILE == 8
    assert [FD.head_tile(g) for g in (1, 8, 9, 12, 16, 71)] == [
        (1, 1), (1, 8), (2, 5), (2, 6), (2, 8), (9, 8)]
    for g in (9, 12, 16, 71):
        assert FD.flash_decode_supported(g, 640, 128, 1)
        assert FD.flash_decode_supported(g, 640, 64, 2)
    assert not FD.flash_decode_supported(4, 640, 80, 1)      # 80 bytes
    assert not FD.flash_decode_supported(4, 640, 48, 1)      # 48 bytes
    assert FD.flash_decode_supported(4, 640, 48, 2)          # 96 bytes


@pytest.mark.parametrize("preset,g,D", [("qwen25_7b", 7, 128),
                                        ("phi3_mini_4k", 1, 96)])
def test_plans_and_policy_at_the_families_heads(preset, g, D):
    cfg = getattr(presets, preset)()
    assert cfg.num_attention_heads // cfg.num_key_value_heads == g
    assert cfg.head_dim_ == D
    n_kv = cfg.num_key_value_heads
    for int8 in (True, False):
        esize = 1 if int8 else 2
        # the smoke's B = 64 rows at S = 640 fill the card at R = 1 with
        # the default cluster table; B = 2 splits
        plan = FD.plan_flash(64, n_kv, g, 640, D, int8, 132)
        assert plan.smem == FD.smem_bytes(g, 640, D, esize, plan.splits)
        assert plan.smem <= FD.LAUNCH_SMEM
        assert FD.plan_flash(2, n_kv, g, 640, D, int8, 132).splits > 1
        assert DA.plan_decode(2, n_kv, g, 640, D, int8, False, 132).splits > 1
    # Phi-3's window makes "auto" batch-major whatever the KV type; a
    # windowless Qwen2.5-7B goes head-major for int8 KV under "auto"
    assert FD.use_head_major_cache("flash", cfg, 640, 1)
    assert FD.use_head_major_cache("flash", cfg, 640, 2)
    assert not FD.use_head_major_cache("auto", cfg, 640, 2)
    assert FD.use_head_major_cache("auto", cfg, 640, 1) is (
        cfg.sliding_window is None)
