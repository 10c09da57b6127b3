"""PyTorch port, ALiBi (Baichuan-13B's attention bias) on the CPU, against
the JAX package:

- `alibi_slopes` bit-equal to JAX's for head counts that are and are not
  powers of two (40: 32 geometric slopes plus 8 interleaved extras);
- `attend` with ALiBi against JAX's `attend` (the relative form,
  slope * (kv_pos - q_pos) after the softcap, before the mask): a T = 1
  query and a prefill chunk, per-row first positions, bf16 and int8 KV, a
  ring read past its wrap; one bf16 ulp of |y| (both sides compute in f32
  from the same operands and round once; the bias adds the same f32 terms);
- kernel 3's plain version with ALiBi (the Pallas kernel's absolute form,
  slope * slot) against the Pallas flash_decode_attention(alibi_slopes=,
  interpret=True), g = 1 and 4, with and without the softcap, bf16 and int8
  KV. ALiBi rows are peaked by construction (the first head's slope is
  2^-2 here), so each row is held as chip_smoke.py holds peaked rows: two
  bf16 ulps of |y| plus PEAK_LEVELS of the row's probability level
  (flash_decode_level), and the plain version without the bias lies far
  beyond that. The absolute and relative forms agree only up to f32
  rounding of the bias, so the plain version is held to JAX's `attend`
  only within the spread JAX's own test_alibi allows the Pallas kernel
  (tests/test_flash_decode.py:84-106, rtol = atol = 3e-2);
- kernel 8's plain version with ALiBi against JAX's `attend` at T = 1
  (one bf16 ulp, as tests/test_torch_decode_attention.py holds it), also
  on a ring; and its refusal of ALiBi with a softcap.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import alibi_slopes as j_alibi_slopes
from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.flash_decode import flash_decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.decode_attention import (decode_attention,
                                                     decode_attention_plain)
from mixq_tpu_torch.kernels.flash_decode import (flash_decode_attention,
                                                 flash_decode_level,
                                                 flash_decode_plain)
from mixq_tpu_torch.models.layers import alibi_slopes, attend

BF16_ULP = 2.0 ** -7
PEAK_LEVELS = {True: 3.0, False: 1.0}   # chip_smoke.py's, peaked rows


def t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


def within_one_ulp(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert np.abs(ref).max() > 0.05
    assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref)).all(), \
        np.abs(got - ref).max()


@pytest.mark.parametrize("n", [1, 4, 6, 8, 12, 40, 64])
def test_alibi_slopes_bit_equal_to_jax(n):
    got = alibi_slopes(n, torch.device("cpu"))
    ref = np.asarray(j_alibi_slopes(n))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    # made once per head count and device
    assert alibi_slopes(n, torch.device("cpu")) is got


def _batch_major(kv_dtype, B, S, nkv, D, rng):
    k = rng.normal(0, 1, (B, S, nkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, nkv, D)).astype(np.float32)
    if kv_dtype == "int8":
        (kq, ks), (vq, vs) = (JQ.quantize_kv(jnp.asarray(x)) for x in (k, v))
        return kq, vq, ks, vs
    return (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
            None, None)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("T,ring", [(1, False), (6, False), (1, True),
                                    (4, True)])
def test_attend_alibi_vs_jax(kv_dtype, T, ring):
    """6 query heads over 3 kv heads (non-power-of-two slopes), queries at
    the last T of 19 positions (ring: 8 slots, wrapped twice; else 24),
    left-padding starts."""
    rng = np.random.default_rng(T + 2 * ring)
    B, nq, nkv, D, n = 3, 6, 3, 32, 19
    S = 8 if ring else 24
    k, v, ks, vs = _batch_major(kv_dtype, B, S, nkv, D, rng)
    q = jnp.asarray(rng.normal(0, 1.5, (B, T, nq, D)), jnp.bfloat16)
    q_slot = jnp.arange(n - T, n, dtype=jnp.int32)
    start = jnp.asarray([0, 2, 16], jnp.int32)
    sl = j_alibi_slopes(nq)
    ref = j_attend(q, k, v, q_slot, jnp.asarray(n), start, k_scale=ks,
                   v_scale=vs, ring=ring, alibi=sl)
    args = (t(q), t(k), t(v), t(q_slot), n, t(start))
    opts = dict(k_scale=t(ks), v_scale=t(vs), ring=ring)
    got = attend(*args, **opts, alibi=alibi_slopes(nq, torch.device("cpu")))
    assert got.dtype == torch.bfloat16
    within_one_ulp(got, ref)
    # the bias moves the result
    free = attend(*args, **opts).float().numpy()
    assert np.abs(free - np.asarray(ref, np.float32)).max() > 1e-2


def _head_major(B, S, nq, nkv, D, int8, rng):
    q = jnp.asarray(rng.normal(0, 1, (B, nq, D)), jnp.bfloat16)
    k = rng.normal(0, 1, (1, nkv, B, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (1, nkv, B, S, D)).astype(np.float32)
    if int8:
        (kq, ks), (vq, vs) = (JQ.quantize_kv(jnp.asarray(x)) for x in (k, v))
        return q, kq, vq, ks, vs
    return (q, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
            None, None)


def _row_levels(got, ref, level):
    """Largest error beyond two bf16 ulps of an output row, in units of
    that row's probability level."""
    over = np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)
    return float((over.max(-1) / level).max())


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2)])
def test_flash_plain_alibi_vs_pallas(nq, nkv, softcap, int8):
    """g = 1 (4/4) and g = 4 (8/2), D = 64, 256 slots, ragged lengths and
    first slots; q x 8 with the softcap, so that the cap binds."""
    rng = np.random.default_rng(nq + int(softcap) + 10 * int8)
    B, S, D = 4, 256, 64
    gain = 8.0 if softcap else 1.0
    q, k, v, ks, vs = _head_major(B, S, nq, nkv, D, int8, rng)
    q = (q.astype(jnp.float32) * gain).astype(jnp.bfloat16)
    lengths = np.array([S, 130, 1, 77], np.int32)
    start = np.array([0, 9, 0, 40], np.int32)
    sl = j_alibi_slopes(nq)
    ref = np.asarray(pallas(q, k, v, jnp.asarray(lengths), ks, vs,
                            kv_start=jnp.asarray(start), layer=0,
                            alibi_slopes=sl, softcap=softcap,
                            interpret=True), np.float32)
    slopes = alibi_slopes(nq, torch.device("cpu"))
    args = (t(q), t(k), t(v), t(lengths), t(ks), t(vs), t(start), 0)
    got = flash_decode_attention(*args, softcap=softcap, alibi_slopes=slopes)
    assert got.dtype == torch.bfloat16 and got.shape == (B, nq, D)
    got = got.float().numpy()
    level = flash_decode_level(*args, softcap=softcap,
                               alibi_slopes=slopes).numpy()
    assert _row_levels(got, ref, level) <= PEAK_LEVELS[int8]
    free = flash_decode_plain(*args, softcap=softcap).float().numpy()
    assert _row_levels(free, ref, level) > 10 * PEAK_LEVELS[int8]
    if not int8 and not softcap:
        # the absolute form against attend's relative one, within JAX's
        # own spread for the Pallas kernel
        qb = jnp.asarray(q)[:, None]
        kb, vb = (jnp.moveaxis(x[0], 0, 2) for x in (k, v))
        rel = j_attend(qb, kb, vb, jnp.asarray(lengths - 1)[:, None],
                       jnp.asarray(lengths), jnp.asarray(start),
                       alibi=sl)[:, 0]
        np.testing.assert_allclose(got, np.asarray(rel, np.float32),
                                   rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_plain_alibi_vs_attend(kv_dtype, ring):
    """Kernel 8's plain version (what the CPU runs for a CPU tensor) with
    ALiBi against JAX's `attend` at T = 1: 6/3 heads, ragged lengths and
    starts (ring: lengths past the wrap of 16 slots)."""
    rng = np.random.default_rng(3 + ring)
    B, nq, nkv, D = 3, 6, 3, 32
    S = 16 if ring else 40
    k, v, ks, vs = _batch_major(kv_dtype, B, S, nkv, D, rng)
    q = jnp.asarray(rng.normal(0, 1.5, (B, nq, D)), jnp.bfloat16)
    lens = np.array([S + 5, S + 11, S + 2] if ring else [S, 23, 9],
                    np.int32)
    starts = (lens - S) if ring else np.array([0, 4, 0], np.int32)
    sl = j_alibi_slopes(nq)
    ref = j_attend(q[:, None], k, v, jnp.asarray(lens - 1)[:, None],
                   jnp.asarray(lens), jnp.asarray(starts), k_scale=ks,
                   v_scale=vs, ring=ring, alibi=sl)[:, 0]
    args = (t(q), t(k), t(v), t(lens), t(ks), t(vs), t(starts))
    slopes = alibi_slopes(nq, torch.device("cpu"))
    got = decode_attention(*args, ring=ring, alibi_slopes=slopes)
    within_one_ulp(got, ref)
    assert torch.equal(got, decode_attention_plain(*args, ring=ring,
                                                   alibi_slopes=slopes))
    free = decode_attention(*args, ring=ring).float().numpy()
    assert np.abs(free - np.asarray(ref, np.float32)).max() > 1e-2


def test_decode_alibi_with_softcap_refused():
    rng = np.random.default_rng(9)
    k, v, ks, vs = _batch_major("int8", 2, 16, 2, 32, rng)
    q = torch.from_numpy(rng.normal(0, 1, (2, 4, 32)).astype(
        np.float32)).to(torch.bfloat16)
    slopes = alibi_slopes(4, torch.device("cpu"))
    with pytest.raises(ValueError, match="ALiBi with a softcap"):
        decode_attention(q, t(k), t(v), 9, t(ks), t(vs), softcap=30.0,
                         alibi_slopes=slopes)
    out = decode_attention(q, t(k), t(v), 9, t(ks), t(vs),
                           alibi_slopes=slopes)
    assert bool(torch.isfinite(out).all())
