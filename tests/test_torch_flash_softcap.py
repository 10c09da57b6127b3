"""PyTorch port, gemma2's attention modes on the CPU:

- kernel 3's plain version (flash_decode_plain) with a logit softcap and a
  score-scale override against the Pallas flash_decode_attention(
  interpret=True, softcap=..., scale=...): int8 and bf16 caches, gemma2's
  GQA g=2 and head_dim 256, caps 50 and 20, scale 24^-0.5, q scaled so that
  the caps bind. Held to test_torch_flash_decode.py's rule (two bf16 ulps of
  |y| plus ATOL: the kernel's recipe is repeated, not approximated), and a
  variant that skips the softcap misses that limit;
- a peaked softmax at gemma2-9B's heads (q x 3: about a third of a row's
  probability on its top slot). There one flipped int8 probability level
  (or bf16 probability ulp) moves a row by up to flash_decode_level
  (max|v| * p_scale / l, or 2^-8 * max|v| / l, with l near 1), beyond
  ATOL, so each row is held to PEAK_LEVELS of its levels: int8 to 3 (the
  plain version reads 2.2 here), and a variant that skips the probability
  quantization misses that by 1.25x or more (it reads 4.1); bf16 to one;
- `attend` (prefill) with scale, softcap and a binding sliding window
  against JAX layers.attend, f32 operands on both sides, to 1e-5 * max|y|
  (f32 summation order and tanh's last ulps)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.flash_decode import flash_decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.flash_decode import (flash_decode_attention,
                                                 flash_decode_level,
                                                 flash_decode_plain)
from mixq_tpu_torch.models.layers import attend

from test_torch_flash_decode import unrounded_probabilities

BF16_ULP = 2.0 ** -7
ATOL = {True: 8e-3, False: 5e-4}                 # int8, bf16 KV
GEMMA2_SCALE = 24.0 ** -0.5        # a query_pre_attn_scalar that is not D
PEAK_LEVELS = {True: 3.0, False: 1.0}   # chip_smoke.py's, peaked rows


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def beyond_two_ulps(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float((np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)).max())


def _case(B, S, nq, nkv, D, int8, seed, q_gain):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(0, q_gain, (B, nq, D)), jnp.bfloat16)
    k = rng.normal(0, 1, (1, nkv, B, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (1, nkv, B, S, D)).astype(np.float32)
    if int8:
        kq, ks = JQ.quantize_kv(jnp.asarray(k))
        vq, vs = JQ.quantize_kv(jnp.asarray(v))
        return q, kq, vq, ks, vs
    return q, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), \
        None, None


@pytest.mark.parametrize("cap", [50.0, 20.0])
@pytest.mark.parametrize("int8", [False, True])
def test_softcap_and_scale_vs_pallas(int8, cap):
    """gemma2-9B's heads (16 q / 8 kv, D = 256) cut to 4 / 2."""
    B, S, nq, nkv, D = 3, 128, 4, 2, 256
    q, k, v, ks, vs = _case(B, S, nq, nkv, D, int8, seed=int(cap) + int8,
                            q_gain=8.0)
    lengths = np.array([S, 70, 9], np.int32)
    start = np.array([0, 5, 3], np.int32)
    ref = pallas(q, k, v, jnp.asarray(lengths), ks, vs,
                 kv_start=jnp.asarray(start), layer=0, interpret=True,
                 softcap=cap, scale=GEMMA2_SCALE)
    args = (t(q), t(k), t(v), t(lengths), None if ks is None else t(ks),
            None if vs is None else t(vs), t(start), 0)
    got = flash_decode_attention(*args, softcap=cap, scale=GEMMA2_SCALE)
    assert got.dtype == torch.bfloat16 and got.shape == (B, nq, D)
    ref = np.asarray(ref, np.float32)
    assert beyond_two_ulps(got.float().numpy(), ref) <= ATOL[int8]
    # the cap binds: without it (or with the default scale) the kernel's
    # function is another one, beyond the limit
    for wrong in (flash_decode_plain(*args, scale=GEMMA2_SCALE),
                  flash_decode_plain(*args, softcap=cap)):
        assert beyond_two_ulps(wrong.float().numpy(), ref) > 2 * ATOL[int8]


def _row_levels(got, ref, level):
    """Largest error beyond two bf16 ulps of an output row, in units of
    that row's probability level."""
    over = np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)
    return float((over.max(-1) / level).max())


@pytest.mark.parametrize("int8", [False, True])
def test_peaked_softmax_limits(int8):
    """gemma2-9B's heads and decode length (16 q / 8 kv, D = 256, 512
    slots) at batch 8, cap 50, its scale 1/16, q x 3."""
    B, S, nq, nkv, D, cap, scale = 8, 512, 16, 8, 256, 50.0, 256.0 ** -0.5
    q, k, v, ks, vs = _case(B, S, nq, nkv, D, int8, seed=10 * int8 + 2,
                            q_gain=3.0)
    rng = np.random.default_rng(5)
    lengths = rng.integers(S // 2, S + 1, B).astype(np.int32)
    start = rng.integers(0, 32, B).astype(np.int32)
    lengths[0] = S
    ref = np.asarray(pallas(q, k, v, jnp.asarray(lengths), ks, vs,
                            kv_start=jnp.asarray(start), layer=0,
                            interpret=True, softcap=cap, scale=scale),
                     np.float32)
    args = (t(q), t(k), t(v), t(lengths), None if ks is None else t(ks),
            None if vs is None else t(vs), t(start), 0)
    got = flash_decode_attention(*args, softcap=cap, scale=scale)
    got = got.float().numpy()
    level = flash_decode_level(*args, softcap=cap, scale=scale).numpy()
    assert level.max() > 2 * ATOL[int8]          # one flip can exceed ATOL
    assert _row_levels(got, ref, level) <= PEAK_LEVELS[int8]
    if int8:
        wrong = unrounded_probabilities(*args, cap, scale).float().numpy()
        assert _row_levels(wrong, got, level) > 1.25 * PEAK_LEVELS[int8]


@pytest.mark.parametrize("T,window,softcap", [(12, 4, 0.5), (12, None, 0.5),
                                              (1, 3, None), (9, 5, None)])
def test_attend_scale_softcap_window_vs_jax(T, window, softcap):
    """Prefill (T > 1) and a T = 1 query on a longer buffer, with gemma2's
    scale override; the window binds whenever it is set."""
    rng = np.random.default_rng(T + (window or 0))
    B, S, nq, nkv, D = 2, 16, 4, 2, 32
    q = rng.normal(0, 1, (B, T, nq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, S, nkv, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, S, nkv, D)).astype(np.float32)
    q_slot = np.arange(S - T, S, dtype=np.int32)
    kv_start = np.array([0, 2], np.int32)
    ref = np.asarray(j_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(q_slot), S,
                              kv_start=jnp.asarray(kv_start),
                              sliding_window=window, scale=GEMMA2_SCALE,
                              softcap=softcap))
    got = attend(t(q), t(k), t(v), t(q_slot), S, kv_start=t(kv_start),
                 sliding_window=window, scale=GEMMA2_SCALE, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # each option changes the result
    plain = attend(t(q), t(k), t(v), t(q_slot), S, kv_start=t(kv_start))
    assert np.abs(plain.numpy() - ref).max() > 1e-2
