"""PyTorch port, the batch-major KV cache and the cache-layout policy on the
CPU, against the JAX package.

- `KVCache.create` in both layouts: batch-major [L, B, S, n_kv, D] with
  [L, B, S, n_kv] scales (no padding), head-major as before.
- `update_layer` bit-equal to JAX's: the int8 values and f32 scales (one
  `quantize_kv`) and the bf16 values, after every write of a sequence of
  chunks and single tokens, batch-major and head-major, and in ring mode
  past the wrap, with a T > 1 chunk that straddles it. Outside ring mode a
  write past S raises.
- `attend` over a batch-major cache (k_scale, v_scale, ring positions, a
  window, starts, gemma2's scale and softcap) against JAX's `attend`, at
  T = 1 and for a prefill chunk: both compute in f32 from the same operands
  and round once to bf16, so the port is held to one bf16 ulp of |y|.
- The policy: `use_head_major_cache` for llama, mistral and gemma2 x int8/
  bf16 KV x max_seq x attn_impl equals JAX's answer on its TPU branch (the
  port reads that branch as the card's, whatever the device), and the
  table of the rows that matter is written out.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import ModelConfig
from mixq_tpu.models.layers import KVCache as JKVCache
from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops.pallas import flash_decode as j_flash
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.flash_decode import use_head_major_cache
from mixq_tpu_torch.models.layers import KVCache, attend

BF16_ULP = 2.0 ** -7
L, B, NKV, D = 2, 3, 2, 16


def t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


def test_create_shapes():
    c = KVCache.create(L, B, 40, NKV, D, torch.int8, device="cpu")
    assert not c.head_major and c.quantized
    assert c.k.shape == (L, B, 40, NKV, D) and c.k_scale.shape == (L, B, 40,
                                                                   NKV)
    assert (c.max_seq, c.batch) == (40, B)
    h = KVCache.create(L, B, 40, NKV, D, torch.int8, head_major=True,
                       device="cpu")
    assert h.k.shape == (L, NKV, B, 40, D) and h.k_scale.shape == (L, NKV, B,
                                                                   128)
    assert (h.max_seq, h.batch) == (40, B)
    b = KVCache.create(L, B, 40, NKV, D, device="cpu")
    assert b.k.dtype == torch.bfloat16 and b.k_scale is None
    j = JKVCache.create(L, B, 40, NKV, D, jnp.int8)
    assert j.k.shape == tuple(c.k.shape)
    assert j.k_scale.shape == tuple(c.k_scale.shape)


def _same(jbuf, tbuf):
    j = np.asarray(jbuf.astype(jnp.float32) if jbuf.dtype == jnp.bfloat16
                   else jbuf)
    tt = tbuf.float().numpy() if tbuf.dtype == torch.bfloat16 else tbuf.numpy()
    assert j.dtype == tt.dtype and np.array_equal(j, tt)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("head_major,ring,S,chunks", [
    (False, False, 16, (5, 1, 1, 1, 4)),
    (True, False, 16, (5, 1, 1, 1, 4)),
    # S=8: positions 0-4, 5-7, then 8 (slot 0), 9-13 (slots 1-5), and a
    # chunk at 14-17 that straddles the wrap (slots 6, 7, 0, 1)
    (False, True, 8, (5, 1, 1, 1, 1, 5, 4)),
    (True, True, 8, (5, 1, 1, 1, 1, 5, 4))])
def test_writes_bit_equal_to_jax(kv_dtype, head_major, ring, S, chunks):
    rng = np.random.default_rng(S + ring + head_major)
    jc = JKVCache.create(L, B, S, NKV, D, jnp.dtype(kv_dtype),
                         head_major=head_major)
    tc = KVCache.create(L, B, S, NKV, D, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    for T in chunks:
        for layer in range(L):
            k = (rng.normal(0, 2, (B, T, NKV, D))).astype(np.float32)
            v = (rng.normal(0, 1, (B, T, NKV, D))).astype(np.float32)
            jc = jc.update_layer(layer, jnp.asarray(k), jnp.asarray(v),
                                 ring=ring)
            tc.update_layer(layer, torch.from_numpy(k), torch.from_numpy(v),
                            ring=ring)
        jc = jc.advance(T)
        tc.advance(T)
        for jb, tb in ((jc.k, tc.k), (jc.v, tc.v), (jc.k_scale, tc.k_scale),
                       (jc.v_scale, tc.v_scale)):
            if jb is None:
                assert tb is None
            else:
                _same(jb, tb)
    assert tc.length == int(jc.length) == sum(chunks)


def test_overflow_guard_outside_ring_mode():
    tc = KVCache.create(1, 1, 4, 1, 16, device="cpu")
    x = torch.zeros(1, 5, 1, 16)
    with pytest.raises(ValueError, match="overflow"):
        tc.update_layer(0, x, x)
    tc.update_layer(0, x[:, :3], x[:, :3]).advance(3)
    tc.update_layer(0, x[:, :3], x[:, :3], ring=True)     # wraps


def _cache(kv_dtype, S, n, ring, seed):
    """A JAX batch-major cache with n positions written in chunks of 3."""
    rng = np.random.default_rng(seed)
    c = JKVCache.create(1, B, S, NKV, 32, jnp.dtype(kv_dtype))
    for p0 in range(0, n, 3):
        T = min(3, n - p0)
        c = c.update_layer(
            0, jnp.asarray(rng.normal(0, 1, (B, T, NKV, 32)), jnp.float32),
            jnp.asarray(rng.normal(0, 1, (B, T, NKV, 32)), jnp.float32),
            ring=ring).advance(T)
    return c.layer_kv(0)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("T,ring,window,gemma", [
    (1, True, 5, False), (4, True, 5, False), (6, False, None, True),
    (1, False, 7, True)])
def test_attend_over_cache_matches_jax(kv_dtype, T, ring, window, gemma):
    """Queries at the last T of 19 positions (ring: a cache of 8 slots,
    wrapped twice; otherwise 24 slots), left-padding starts."""
    n, S = 19, (8 if ring else 24)
    k, v, ks, vs = _cache(kv_dtype, S, n, ring, seed=T + ring)
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(0, 1.5, (B, T, 4, 32)), jnp.bfloat16)
    q_slot = jnp.arange(n - T, n, dtype=jnp.int32)
    start = jnp.asarray([0, 2, 16], jnp.int32)
    opts = dict(scale=24.0 ** -0.5, softcap=0.5) if gemma else {}
    ref = j_attend(q, k, v, q_slot, jnp.asarray(n), start,
                   sliding_window=window, k_scale=ks, v_scale=vs, ring=ring,
                   **opts)
    got = attend(t(q), t(k), t(v), t(q_slot), n, t(start),
                 sliding_window=window, k_scale=t(ks), v_scale=t(vs),
                 ring=ring, **opts)
    ref = np.asarray(ref, np.float32)
    assert got.dtype == torch.bfloat16 and np.abs(ref).max() > 0.05
    assert (np.abs(got.float().numpy() - ref) <= BF16_ULP * np.abs(ref)).all()


def _cfg(family, head_dim):
    if family == "llama":
        return ModelConfig.tiny(head_dim=head_dim)
    if family == "mistral":
        return ModelConfig.tiny(model_type="mistral", sliding_window=4096,
                                num_attention_heads=8, num_key_value_heads=2,
                                head_dim=head_dim)
    return ModelConfig.tiny(
        model_type="gemma2", num_attention_heads=4, num_key_value_heads=2,
        head_dim=head_dim, attn_logit_softcap=50.0,
        query_pre_attn_scalar=256.0, sliding_window=4096,
        sliding_window_pattern=2)


# (family, attn_impl, KV bytes, max_seq) -> head-major?  (head_dim 128)
TABLE = {
    ("llama", "auto", 1, 64): False, ("llama", "auto", 1, 128): True,
    ("llama", "auto", 1, 4096): True, ("llama", "auto", 2, 4096): False,
    ("llama", "flash", 2, 128): True, ("llama", "xla", 1, 4096): False,
    ("mistral", "auto", 1, 4096): False, ("mistral", "flash", 1, 4096): True,
    ("mistral", "flash", 2, 8192): True,
    ("gemma2", "auto", 1, 4096): False, ("gemma2", "flash", 1, 4096): True,
    ("gemma2", "flash", 1, 8192): False, ("gemma2", "flash", 2, 640): True,
}


def test_policy_table(monkeypatch):
    """The port's policy equals JAX's TPU branch on every combination that
    the TPU kernel's VMEM budget admits (the port's gate is its kernel's
    shared memory instead; the JAX package answers for the CPU with "auto"
    -> batch-major always, so its backend is set to "tpu" here), and the
    written table holds."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for family in ("llama", "mistral", "gemma2"):
        for hd in (128, 256):
            cfg = _cfg(family, hd)
            for impl in ("auto", "flash", "xla"):
                for itemsize in (1, 2):
                    for S in (64, 127, 128, 640, 4096, 8192):
                        if not j_flash.flash_decode_supported(
                                cfg.num_key_value_heads, S, hd, itemsize):
                            continue      # the TPU kernel's VMEM budget
                        got = use_head_major_cache(impl, cfg, S, itemsize)
                        ref = j_flash.use_head_major_cache(impl, cfg, S,
                                                           itemsize)
                        assert got == ref, (family, hd, impl, itemsize, S)
                        if hd == 128 and (family, impl, itemsize,
                                          S) in TABLE:
                            assert got == TABLE[family, impl, itemsize, S]
    # ALiBi models take the batch-major cache under "auto" (JAX's policy)
    alibi = dataclasses.replace(_cfg("llama", 128), alibi=True)
    assert not use_head_major_cache("auto", alibi, 4096, 1)
