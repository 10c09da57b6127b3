"""PyTorch port, the speculative verify in slot mode: the T>1 span write
`KVCache.update_layer_slots` and `forward(..., slot_lengths=...)` at T>1
against JAX's (mixq_tpu/models/layers.py:591-650, decoder.py:368-424,
:611-646), on the CPU.

- The span write is bit-equal to JAX's: on the batch-major cache to JAX's
  T>1 span scatter, and in every layout (batch-major, head-major with its
  128-padded scales, a batch-major ring past its wrap) to JAX's T=1 writes
  of the span's tokens one by one at slot_lengths + t (quantize_kv is per
  (token, head), so a span's int8 bits are its tokens'); bf16 and int8 KV.
  The scalar length does not move.
- The verify forward (T=4 at ragged per-row lengths, after a prefill, twice)
  on the tiny W8A8O16 llama of tests/test_torch_models.py: logits within
  tests/test_torch_decoder.py's 5e-3 * max|logits| of JAX's eager
  batch-major forward, bf16 and int8 KV.
- With every row at one length the verify's logits are bit-equal to the
  scalar-length T=4 forward's on the same batch-major cache.
- `attend` with the verify's [B, T] query positions, which the verify
  takes on the batch-major pool, is within one bf16 ulp of JAX's.
- The head-major verify (kernel 3's plain version once per token t, at
  per-row length slot_lengths + t + 1) against the batch-major verify
  (`attend` with [B, T] query positions) on the same int8 cache: within
  1.5x the gap between JAX's own two paths on that cache (the Pallas
  kernel with interpret=True once per t against JAX's `attend`), and each
  t within kernel 3's limit of the Pallas kernel (two bf16 ulps + 8e-3).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.flash_decode import flash_decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.models.decoder import _verify_attend, forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

L, B, S, NKV, HD, T = 2, 4, 16, 2, 32, 4
BF16_ULP = 2.0 ** -7


def _caches(kv_dtype, head_major, seed=0):
    """A JAX cache and a port cache holding the same random contents."""
    jc = JKVCache.create(L, B, S, NKV, HD, jnp.dtype(kv_dtype),
                         head_major=head_major, tail_r=0)
    tc = KVCache.create(L, B, S, NKV, HD, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    rng = np.random.default_rng(seed)
    fields = {}
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(tc, name)
        if t is None:
            continue
        if t.dtype == torch.int8:
            a = rng.integers(-127, 128, t.shape).astype(np.int8)
            fields[name] = jnp.asarray(a)
            t.copy_(torch.from_numpy(a))
        else:
            a = rng.normal(size=t.shape).astype(np.float32)
            fields[name] = jnp.asarray(a).astype(
                jnp.float32 if name.endswith("scale") else jnp.bfloat16)
            t.copy_(torch.from_numpy(a).to(t.dtype))
    return jc._replace(**fields), tc


def _equal(jc, tc):
    for name in ("k", "v", "k_scale", "v_scale"):
        t = getattr(tc, name)
        if t is None:
            continue
        j = np.asarray(jnp.asarray(getattr(jc, name)).astype(jnp.float32))
        assert np.array_equal(j, t.float().numpy()), name


def _span(rng):
    kn = rng.normal(size=(B, T, NKV, HD)).astype(np.float32)
    vn = rng.normal(size=(B, T, NKV, HD)).astype(np.float32)
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)   # noqa: E731
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return (bf(kn), bf(vn)), (tb(kn), tb(vn))


@pytest.mark.parametrize("kv_dtype,head_major,ring", [
    ("bfloat16", False, False), ("int8", False, False),
    ("int8", True, False), ("bfloat16", True, False),
    ("int8", False, True), ("bfloat16", False, True)])
def test_span_write_bit_equal_to_jax_token_writes(kv_dtype, head_major,
                                                   ring):
    jc, tc = _caches(kv_dtype, head_major)
    rng = np.random.default_rng(1)
    lengths = np.array([0, 5, S - T, 9], np.int32)
    if ring:
        lengths += np.array([S, 2 * S, 0, S - 2], np.int32)   # wraps
    for layer in range(L):
        (jk, jv), (tk, tv) = _span(rng)
        for t in range(T):
            jc = jc.update_layer_slots(layer, jk[:, t:t + 1], jv[:, t:t + 1],
                                       jnp.asarray(lengths + t), ring=ring)
        tc.update_layer_slots(layer, tk, tv, torch.from_numpy(lengths),
                              ring=ring)
    _equal(jc, tc)
    assert int(tc.length) == 0 and tc.host_length == 0


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_span_write_bit_equal_to_jax_span_scatter(kv_dtype):
    jc, tc = _caches(kv_dtype, False, seed=2)
    rng = np.random.default_rng(3)
    lengths = np.array([3, 0, S - T, 7], np.int32)
    for layer in range(L):
        (jk, jv), (tk, tv) = _span(rng)
        jc = jc.update_layer_slots(layer, jk, jv, jnp.asarray(lengths))
        tc.update_layer_slots(layer, tk, tv, torch.from_numpy(lengths))
    _equal(jc, tc)


def _model_caches(cfg, kv_dtype, head_major=False, Sc=32):
    dims = (cfg.num_hidden_layers, B, Sc, cfg.num_key_value_heads,
            cfg.head_dim_)
    jc = JKVCache.create(*dims, jnp.dtype(kv_dtype), head_major=head_major,
                         tail_r=0)
    tc = KVCache.create(*dims, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    return jc, tc


@pytest.fixture(scope="module")
def world():
    return models.build(1)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_verify_forward_matches_jax(world, kv_dtype):
    cfg, jp, jspecs, tp, tspecs = world
    jspecs = dataclasses.replace(jspecs, attn_impl="auto")
    head = lm_head_f32(tp, tspecs)
    jc, tc = _model_caches(cfg, kv_dtype)
    rng = np.random.default_rng(5)
    P = 8
    toks = rng.integers(1, cfg.vocab_size, (B, P + 2 * T)).astype(np.int32)
    _, jc = j_forward(jp, jnp.asarray(toks[:, :P]), jc, jspecs, cfg)
    forward(tp, torch.from_numpy(toks[:, :P]), tc, tspecs, cfg,
            head_f32=head)
    lengths = np.array([P, 3, 0, 6], np.int32)       # ragged; 0 restarts
    for r in range(2):
        feed = toks[:, P + r * T:P + (r + 1) * T]
        jl, jc = j_forward(jp, jnp.asarray(feed), jc, jspecs, cfg,
                           slot_lengths=jnp.asarray(lengths))
        tl, _ = forward(tp, torch.from_numpy(feed), tc, tspecs, cfg,
                        head_f32=head, slot_lengths=torch.from_numpy(lengths))
        jl = np.asarray(jl)
        assert tl.shape == (B, T, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())
        lengths = lengths + np.array([T, 2, 1, 0], np.int32)
    assert int(tc.length) == P and tc.host_length == P


def test_equal_lengths_bit_equal_to_scalar_verify(world):
    cfg, _, _, tp, tspecs = world
    head = lm_head_f32(tp, tspecs)
    _, tc = _model_caches(cfg, "int8")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, cfg.vocab_size, (B, 9 + T)).astype(np.int32))
    forward(tp, toks[:, :9], tc, tspecs, cfg, head_f32=head)
    slot, _ = forward(tp, toks[:, 9:], tc, tspecs, cfg, head_f32=head,
                      slot_lengths=torch.full((B,), 9, dtype=torch.int32))
    assert tc.host_length == 9
    scalar, _ = forward(tp, toks[:, 9:], tc, tspecs, cfg, head_f32=head)
    assert torch.equal(slot, scalar)


def test_head_major_verify_within_jax_own_gap():
    Sv, nq, nkv, D = 64, 8, 2, 64
    rng = np.random.default_rng(7)
    kf = rng.normal(0, 1, (1, nkv, B, Sv, D)).astype(np.float32)
    vf = rng.normal(0, 1, (1, nkv, B, Sv, D)).astype(np.float32)
    kq, ks = JQ.quantize_kv(jnp.asarray(kf))
    vq, vs = JQ.quantize_kv(jnp.asarray(vf))
    q = jnp.asarray(rng.normal(0, 1, (B, T, nq, D)), jnp.bfloat16)
    lengths = np.array([0, 17, Sv - T, 40], np.int32)
    # JAX's two paths on the same int8 cache
    jhm = np.stack([np.asarray(pallas(
        q[:, t], kq, vq, jnp.asarray(lengths + t + 1), ks, vs, layer=0,
        interpret=True), np.float32) for t in range(T)], axis=1)
    bm = lambda a: jnp.moveaxis(a[0], 0, 2)          # noqa: E731
    q_slot = jnp.asarray(lengths)[:, None] + jnp.arange(T)[None]
    jbm = np.asarray(j_attend(q, bm(kq), bm(vq), q_slot,
                              jnp.asarray(lengths + T), k_scale=bm(ks),
                              v_scale=bm(vs)), np.float32)
    # the port's two paths
    tt = lambda a: tensor_from_numpy(np.asarray(a), "cpu")   # noqa: E731
    tq, tk, tv, tks, tvs = map(tt, (q, kq[0], vq[0], ks[0], vs[0]))
    tl = torch.from_numpy(lengths)
    t_slot = tl[:, None] + torch.arange(T)[None]
    hm = _verify_attend(tq, tk, tv, tks, tvs, t_slot, tl, None, None, True,
                        False, None, None, None).float().numpy()
    tbm = lambda a: a.movedim(0, 2)                  # noqa: E731
    pbm = _verify_attend(tq, tbm(tk), tbm(tv), tbm(tks), tbm(tvs), t_slot,
                         tl, None, None, False, False, None, None,
                         None).float().numpy()
    jax_gap = np.abs(jhm - jbm).max()
    port_gap = np.abs(hm - pbm).max()
    assert 0 < port_gap <= 1.5 * jax_gap, (port_gap, jax_gap)
    beyond = np.abs(hm - jhm) - 2 * BF16_ULP * np.abs(jhm)
    assert beyond.max() <= 8e-3
    np.testing.assert_allclose(pbm, jbm, rtol=0, atol=2 * BF16_ULP
                               * np.abs(jbm).max())


@pytest.mark.parametrize("int8,ring,alibi,window", [
    (False, False, False, None), (True, False, False, None),
    (True, True, True, 8), (False, False, True, None)])
def test_attend_verify_positions_vs_jax(int8, ring, alibi, window):
    """`attend` with the verify's [B, T] query positions at per-row lengths
    (the batch-major pool's verify) against JAX's `attend` on the same
    inputs: int8 scales, a ring past its wrap, ALiBi, a window and
    kv_start included; within one bf16 ulp of |JAX's output| (both sum
    in f32 on the CPU, the port in [B, n_kv, S, D] matmuls, JAX in
    einsums)."""
    from mixq_tpu.models.layers import alibi_slopes as j_alibi_slopes
    from mixq_tpu_torch.models.layers import alibi_slopes, attend

    rng = np.random.default_rng(0)
    nq, nkv, D, Sv = 8, 2, 32, 40
    q = rng.normal(0, 1, (3, T, nq, D)).astype(np.float32)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16))
    if int8:
        k = rng.integers(-127, 128, (3, Sv, nkv, D), dtype=np.int8)
        v = k[:, ::-1].copy()
        ks, vs = (rng.random((3, Sv, nkv), dtype=np.float32)
                  for _ in range(2))
    else:
        k, v = (np.asarray(jnp.asarray(rng.normal(0, 1, (3, Sv, nkv, D)),
                                       jnp.bfloat16)) for _ in range(2))
        ks = vs = None
    lengths = np.array([50, 33, 70] if ring else [5, 20, Sv - T], np.int32)
    q_slot = lengths[:, None] + np.arange(T, dtype=np.int32)[None]
    start = np.array([0, 2, 1], np.int32)
    J = lambda a: None if a is None else jnp.asarray(a)     # noqa: E731
    P = lambda a: (None if a is None                        # noqa: E731
                   else tensor_from_numpy(np.asarray(a), "cpu"))
    ref = np.asarray(j_attend(
        J(q), J(k), J(v), J(q_slot), J(lengths + T), J(start),
        sliding_window=window, k_scale=J(ks), v_scale=J(vs), ring=ring,
        alibi=j_alibi_slopes(nq) if alibi else None), np.float32)
    got = attend(P(q), P(k), P(v), P(q_slot), P(lengths + T),
                 kv_start=P(start), sliding_window=window, k_scale=P(ks),
                 v_scale=P(vs), ring=ring,
                 alibi=alibi_slopes(nq, torch.device("cpu")) if alibi
                 else None)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(ref).max() > 0.05
    assert np.all(np.abs(got - ref) <= BF16_ULP * np.abs(ref) + 1e-6)
