"""PyTorch port, kernel 3 (kernels/flash_decode.py) on the CPU: its plain
version against the Pallas flash_decode_attention(interpret=True), for bf16
and int8 head-major caches, MHA and GQA, per-row lengths that include 0 and
S, and kv_start, on a stacked [L, ...] cache read at a layer index.

JAX's own kernel tests hold the kernel to 3e-2 against `attend`. The port
repeats the kernel's arithmetic, so it is held tighter, relative to the
output's scale (a typical |y| is ~0.1 here): two bf16 ulps of |y|, plus
ATOL for a probability whose rounding (to int8, or to bf16 in bf16 mode) an
exp() ulp flips. ATOL is the limit the CUDA kernel is held to against this
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py); the
largest error beyond two ulps seen here is 1.8e-3 (int8, 4 heads). A
variant that skips the int8 probability quantization misses by more than
ATOL, and `test_tolerance_pins_the_int8_recipe` holds that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.flash_decode import flash_decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.flash_decode import (flash_decode_attention,
                                                 flash_decode_plain)

BF16_ULP = 2.0 ** -7
ATOL = {True: 8e-3, False: 5e-4}                 # int8, bf16 KV


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def beyond_two_ulps(got, ref):
    """Largest |got - ref| beyond two bf16 ulps of |ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float((np.abs(got - ref) - 2 * BF16_ULP * np.abs(ref)).max())


def _case(B, S, nq, nkv, D, int8, seed, L=2, pad_scales=False):
    rng = np.random.default_rng(seed)
    q = jnp.asarray(rng.normal(0, 1, (B, nq, D)), jnp.bfloat16)
    k = rng.normal(0, 1, (L, nkv, B, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (L, nkv, B, S, D)).astype(np.float32)
    if int8:
        kq, ks = JQ.quantize_kv(jnp.asarray(k))
        vq, vs = JQ.quantize_kv(jnp.asarray(v))
        if pad_scales:
            Sp = -(-S // 128) * 128
            pad = ((0, 0),) * 3 + ((0, Sp - S),)
            ks, vs = jnp.pad(ks, pad, constant_values=1.0), jnp.pad(
                vs, pad, constant_values=1.0)
        return q, kq, vq, ks, vs
    return q, jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), \
        None, None


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D", [(4, 4, 64), (8, 2, 128)])
def test_plain_vs_pallas(int8, nq, nkv, D):
    B, S = 4, 128
    q, k, v, ks, vs = _case(B, S, nq, nkv, D, int8, seed=nq + D + int8)
    lengths = np.array([S, 70, 0, 9], np.int32)
    start = np.array([0, 5, 0, 3], np.int32)
    ref = pallas(q, k, v, jnp.asarray(lengths), ks, vs,
                 kv_start=jnp.asarray(start), layer=1, interpret=True)
    got = flash_decode_attention(
        t(q), t(k), t(v), t(lengths), None if ks is None else t(ks),
        None if vs is None else t(vs), kv_start=t(start), layer=1)
    assert got.dtype == torch.bfloat16 and got.shape == (B, nq, D)
    ref = np.asarray(ref, np.float32)
    assert beyond_two_ulps(got.float().numpy(), ref) <= ATOL[int8]
    assert (got[2] == 0).all()                   # length-0 row is zeroed
    assert np.abs(ref).max() > 0.1               # and the rest is not


def test_padded_scales_and_scalar_length():
    """Scales padded to %128 (as KVCache.create allocates them) and a
    scalar length / no kv_start, as the decoder's decode step passes."""
    B, S, nq, nkv, D = 3, 96, 4, 4, 64
    q, k, v, ks, vs = _case(B, S, nq, nkv, D, True, seed=11,
                            pad_scales=True)
    assert ks.shape[-1] == 128
    ref = pallas(q, k, v, 50, ks, vs, layer=0, interpret=True)
    got = flash_decode_attention(t(q), t(k), t(v), 50, t(ks), t(vs), layer=0)
    assert beyond_two_ulps(got.float().numpy(), ref) <= ATOL[True]


def unrounded_probabilities(q, k, v, lengths, ks, vs, starts, layer,
                            softcap=0.0, scale=None):
    """The kernel's recipe without its probability rounding (int8: f32 p
    times v_scale times the int8 v, no p quantization; bf16: p kept in
    f32): a plausible wrong kernel."""
    k, v = k[layer].float(), v[layer].float()
    B, n_q, D = q.shape
    n_kv, _, S, _ = k.shape
    scale = D ** -0.5 if scale is None else scale
    qf = q.float().reshape(B, n_kv, n_q // n_kv, D)
    kt = k.permute(1, 0, 3, 2)
    if ks is not None:
        q_scale = (qf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
        q_i8 = (qf / q_scale).round().clamp(-127, 127)
        s = (q_i8 @ kt * q_scale
             * ks[layer][..., :S].permute(1, 0, 2)[:, :, None, :] * scale)
    else:
        s = qf @ kt * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S)
    valid = (pos[None] < lengths[:, None]) & (pos[None] >= starts[:, None])
    s = s.masked_fill(~valid[:, None, None], -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p2 = (p if vs is None
          else p * vs[layer][..., :S].permute(1, 0, 2)[:, :, None, :])
    o = p2 @ v.permute(1, 0, 2, 3) / p.sum(-1, keepdim=True)
    return o.reshape(B, n_q, D).to(torch.bfloat16)


@pytest.mark.parametrize("nq,nkv", [(32, 32), (32, 8)])
def test_tolerance_pins_the_int8_recipe(nq, nkv):
    """At Llama-2-7B's heads and a decode-like length (hundreds of valid
    slots, as in the smoke's kernel phase) ATOL stops a variant that skips
    the probability quantization by a margin of at least 1.5x."""
    B, S, D = 16, 512, 128
    q, k, v, ks, vs = _case(B, S, nq, nkv, D, True, seed=nq + nkv, L=1)
    rng = np.random.default_rng(nq)
    lengths = rng.integers(S // 2, S + 1, B).astype(np.int32)
    start = rng.integers(0, 32, B).astype(np.int32)
    q, k, v, ks, vs, lengths, start = (t(a) for a in (q, k, v, ks, vs,
                                                      lengths, start))
    ref = flash_decode_plain(q, k, v, lengths, ks, vs, kv_start=start,
                             layer=0)
    wrong = unrounded_probabilities(q, k, v, lengths, ks, vs, start, 0)
    assert beyond_two_ulps(wrong.float().numpy(),
                           ref.float().numpy()) > 1.5 * ATOL[True]


def test_row_without_valid_slot_is_zero():
    """start >= length > 0: the port writes zeros (documented difference
    from the Pallas kernel, which averages over the masked slots)."""
    B, S, nq, nkv, D = 2, 32, 2, 2, 32
    q, k, v, _, _ = _case(B, S, nq, nkv, D, False, seed=3, L=1)
    got = flash_decode_plain(t(q), t(k), t(v), t(np.array([8, 8], np.int32)),
                             kv_start=t(np.array([8, 2], np.int32)), layer=0)
    assert (got[0] == 0).all() and (got[1] != 0).any()
