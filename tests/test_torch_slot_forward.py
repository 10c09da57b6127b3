"""PyTorch port, the continuous-batching slot mode of the model: the per-row
KV write `KVCache.update_layer_slots` and `forward(..., slot_lengths=...)`
against JAX's (mixq_tpu/models/layers.py:591-650, decoder.py:368-424).

- update_layer_slots bit-equal to JAX's (a cache without JAX's tail window)
  on the batch-major cache with bf16 and int8 KV, the head-major one with
  int8 (scales in their 128-padded layout) and bf16, and a batch-major ring
  (positions past S wrap). T > 1 (the speculative verify's span):
  tests/test_torch_slot_verify.py.
- forward at ragged per-row lengths, teacher-forced for 3 steps after a
  prefill, on the tiny W8A8O16 llama of tests/test_torch_models.py: logits
  within tests/test_torch_decoder.py's 5e-3 * max|logits| of JAX's eager
  forward, bf16 KV on the batch-major cache (kernel 8's plain version) and
  int8 KV on the head-major one (kernel 3's); the scalar length stays.
- With every row at one length, the slot-mode logits are bit-equal to the
  scalar-length forward's on the same batch and cache.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

L, B, S, NKV, HD = 2, 4, 8, 2, 32


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
        j = jnp.asarray(getattr(jc, name))
        if t.dtype == torch.bfloat16:
            assert np.array_equal(np.asarray(j.astype(jnp.float32)),
                                  t.float().numpy()), name
        else:
            assert np.array_equal(np.asarray(j), t.numpy()), name


@pytest.mark.parametrize("kv_dtype,head_major,ring", [
    ("bfloat16", False, False), ("int8", False, False),
    ("int8", True, False), ("bfloat16", True, False),
    ("int8", False, True), ("bfloat16", False, True)])
def test_update_layer_slots_bit_equal(kv_dtype, head_major, ring):
    jc, tc = _caches(kv_dtype, head_major)
    rng = np.random.default_rng(1)
    lengths = np.array([0, 5, 7, 3], np.int32)
    if ring:
        lengths += np.array([S, 2 * S, 0, S], np.int32)      # wrap past S
    for layer in range(L):
        kn = rng.normal(size=(B, 1, NKV, HD)).astype(np.float32)
        vn = rng.normal(size=(B, 1, NKV, HD)).astype(np.float32)
        jc = jc.update_layer_slots(
            layer, jnp.asarray(kn).astype(jnp.bfloat16),
            jnp.asarray(vn).astype(jnp.bfloat16), jnp.asarray(lengths),
            ring=ring)
        tc.update_layer_slots(
            layer, torch.from_numpy(kn).to(torch.bfloat16),
            torch.from_numpy(vn).to(torch.bfloat16),
            torch.from_numpy(lengths), ring=ring)
    _equal(jc, tc)
    assert int(tc.length) == 0 and tc.host_length == 0


def _model_caches(cfg, kv_dtype, head_major, Sc=32):
    dims = (cfg.num_hidden_layers, B, Sc, cfg.num_key_value_heads,
            cfg.head_dim_)
    jc = JKVCache.create(*dims, jnp.dtype(kv_dtype), head_major=head_major,
                         tail_r=0)
    tc = KVCache.create(*dims, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    return jc, tc


@pytest.mark.parametrize("kv_dtype,head_major", [("bfloat16", False),
                                                 ("int8", True)])
def test_ragged_slot_forward_matches_jax(kv_dtype, head_major):
    cfg, jp, jspecs, tp, tspecs = models.build(1)
    head = lm_head_f32(tp, tspecs)
    jc, tc = _model_caches(cfg, kv_dtype, head_major)
    rng = np.random.default_rng(3)
    T = 8
    toks = rng.integers(1, cfg.vocab_size, (B, T + 3)).astype(np.int32)
    _, jc = j_forward(jp, jnp.asarray(toks[:, :T]), jc, jspecs, cfg)
    forward(tp, torch.from_numpy(toks[:, :T]), tc, tspecs, cfg,
            head_f32=head)
    # rows continue from their own lengths (a row at 0 restarts, 7 ragged)
    lengths = np.array([T, 3, 0, 6], np.int32)
    for step in range(3):
        tok = toks[:, T + step:T + step + 1]
        jl, jc = j_forward(jp, jnp.asarray(tok), jc, jspecs, cfg,
                           slot_lengths=jnp.asarray(lengths))
        tl, _ = forward(tp, torch.from_numpy(tok), tc, tspecs, cfg,
                        head_f32=head,
                        slot_lengths=torch.from_numpy(lengths))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())
        lengths = lengths + 1
    assert int(tc.length) == T and tc.host_length == T


@pytest.mark.parametrize("kv_dtype,head_major", [("bfloat16", False),
                                                 ("int8", True),
                                                 ("int8", False)])
def test_equal_lengths_bit_equal_to_scalar_forward(kv_dtype, head_major):
    cfg, _, _, tp, tspecs = models.build(2)
    head = lm_head_f32(tp, tspecs)
    _, tc = _model_caches(cfg, kv_dtype, head_major)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, (B, 10)).astype(np.int32))
    forward(tp, toks[:, :9], tc, tspecs, cfg, head_f32=head)
    slot, _ = forward(tp, toks[:, 9:], tc, tspecs, cfg, head_f32=head,
                      slot_lengths=torch.full((B,), 9, dtype=torch.int32))
    assert tc.host_length == 9
    scalar, _ = forward(tp, toks[:, 9:], tc, tspecs, cfg, head_f32=head)
    assert torch.equal(slot, scalar)
