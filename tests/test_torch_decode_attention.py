"""PyTorch port, kernel 8 (kernels/decode_attention.py) on the CPU: its plain
version against the Pallas decode_attention(interpret=True) in every case of
tests/test_decode_attention.py, and against JAX's `attend` over a
batch-major cache at T=1 (the function the decoder's decode step replaces)
with a ring cache read past its wrap, a window bound, left-padding starts,
gemma2's softcap and score scale, and a row with no valid position.

Tolerances. Both JAX functions and the plain version compute in f32 from
the same widened operands and round once to bf16. Against Pallas and
`attend` the plain version is held to one bf16 ulp of |y| (it reads 0: bit-
equal in every case here). The score scale: `attend` rounds 1/sqrt(D) as the
f32 reciprocal of the f32 sqrt, the Pallas kernel the Python double 1/D**0.5
to f32; for D in {32, 64, 128, 256} the two are the same f32 number
(`test_scale_roundings_agree`). The CUDA kernel is held to its plain version
within two bf16 ulps of |y| plus DECODE_ATOL (tests/test_torch_gpu.py,
chip_smoke.py); `test_tolerance_pins_the_widened_recipe` shows that a kernel
following kernel 3's int8 recipe (q and p quantized) misses that limit by
more than 1.5x."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import KVCache as JKVCache
from mixq_tpu.models.layers import attend as j_attend
from mixq_tpu.ops.pallas.decode_attention import decode_attention as pallas
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.decode_attention import (DECODE_ATOL,
                                                     decode_attention,
                                                     decode_attention_plain)
from mixq_tpu_torch.kernels.flash_decode import flash_decode_plain

BF16_ULP = 2.0 ** -7


def t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


def within_one_ulp(got, ref):
    got, ref = (np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                           else x, np.float32) for x in (got, ref))
    assert np.abs(ref).max() > 0.05
    assert (np.abs(got - ref) <= BF16_ULP * np.abs(ref)).all(), \
        np.abs(got - ref).max()


def setup(B=2, S=32, n_q=4, n_kv=2, D=128, kv_dtype=jnp.bfloat16, seed=0):
    """tests/test_decode_attention.py's setup: the cache filled through
    JAX's own batch-major write (and int8 quantization)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(ks[0], (B, 1, n_q, D)).astype(jnp.bfloat16)
    k_raw = jax.random.normal(ks[1], (B, S, n_kv, D)) * 2.0
    v_raw = jax.random.normal(ks[2], (B, S, n_kv, D))
    c = JKVCache.create(1, B, S, n_kv, D, kv_dtype).update_layer(
        0, k_raw, v_raw)
    return (q,) + tuple(c.layer_kv(0))


@pytest.mark.parametrize("case", ["bf16", "int8", "mha", "per_row_lengths",
                                  "masking_excludes_garbage"])
def test_plain_vs_pallas(case):
    kw = dict(bf16=dict(), int8=dict(kv_dtype=jnp.int8),
              mha=dict(n_q=4, n_kv=4, kv_dtype=jnp.int8),
              per_row_lengths=dict(B=3, kv_dtype=jnp.int8, seed=1),
              masking_excludes_garbage=dict(seed=2))[case]
    q, k, v, ks, vs = setup(**kw)
    kv_len = {"mha": 32, "per_row_lengths": jnp.asarray([5, 20, 32],
                                                         jnp.int32),
              "masking_excludes_garbage": 10}.get(case, 20)
    if case == "masking_excludes_garbage":
        k = k.at[:, kv_len:].set(99.0)
        v = v.at[:, kv_len:].set(-99.0)
    ref = pallas(q[:, 0], k, v, kv_len, ks, vs, interpret=True)
    got = decode_attention(t(q[:, 0]), t(k), t(v),
                           kv_len if isinstance(kv_len, int) else t(kv_len),
                           t(ks), t(vs))
    assert got.dtype == torch.bfloat16 and got.shape == q[:, 0].shape
    within_one_ulp(got, ref)
    if case == "masking_excludes_garbage":
        clean = setup(**kw)
        within_one_ulp(got, decode_attention_plain(
            t(clean[0][:, 0]), t(clean[1]), t(clean[2]), kv_len))


def test_scale_roundings_agree():
    for D in (32, 64, 128, 256):
        assert np.float32(1.0 / (D ** 0.5)) == np.float32(
            1.0 / jnp.sqrt(D).astype(jnp.float32))


def _ring_case(B, S, n_q, n_kv, D, int8, seed, lens):
    """A batch-major cache written by JAX's ring update past its wrap: each
    row's positions up to lens[b] - 1 (written for the largest length, so a
    shorter row's newest slots are ahead of it, as after a longer row's
    decode) and q for the query at lens[b] - 1."""
    rng = np.random.default_rng(seed)
    dt = jnp.int8 if int8 else jnp.bfloat16
    c = JKVCache.create(1, B, S, n_kv, D, dt)
    n = int(max(lens))
    for p0 in range(0, n, 3):          # chunks of 3 straddle the wraps
        T = min(3, n - p0)
        kk = jnp.asarray(rng.normal(0, 1, (B, T, n_kv, D)), jnp.float32)
        vv = jnp.asarray(rng.normal(0, 1, (B, T, n_kv, D)), jnp.float32)
        c = c.update_layer(0, kk, vv, ring=True)._replace(
            length=c.length + T)
    q = jnp.asarray(rng.normal(0, 1.5, (B, 1, n_q, D)), jnp.bfloat16)
    return (q,) + tuple(c.layer_kv(0))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_q,n_kv,opts", [
    (4, 4, dict()),
    (4, 2, dict(window=5)),
    (8, 2, dict(window=6, scale=24.0 ** -0.5, softcap=0.5))])
def test_ring_window_softcap_vs_attend(int8, n_q, n_kv, opts):
    """Ring cache of 8 slots read at lengths past the wrap (12 and 19) and
    before it (7), per-row starts (left padding), a window bound, and
    gemma2's scale and softcap, against JAX attend(ring=True)."""
    B, S, D = 3, 8, 32
    lens = np.array([12, 19, 7], np.int32)
    start = np.array([0, 13, 2], np.int32)
    q, k, v, ks, vs = _ring_case(B, S, n_q, n_kv, D, int8, n_q + int8, lens)
    W = opts.get("window")
    # attend takes one query slot for the batch: one row at a time
    for b in range(B):
        sl = slice(b, b + 1)
        ref = j_attend(q[sl], k[sl], v[sl], jnp.asarray([lens[b] - 1]),
                       jnp.asarray(lens[b]), jnp.asarray(start[sl]),
                       sliding_window=W,
                       k_scale=None if ks is None else ks[sl],
                       v_scale=None if vs is None else vs[sl],
                       scale=opts.get("scale"), softcap=opts.get("softcap"),
                       ring=True)[:, 0]
        lo = start[b] if W is None else max(start[b], lens[b] - W)
        got = decode_attention(
            t(q[sl, 0]), t(k[sl]), t(v[sl]), int(lens[b]),
            t(None if ks is None else ks[sl]),
            t(None if vs is None else vs[sl]), kv_start=int(lo), ring=True,
            scale=opts.get("scale"), softcap=opts.get("softcap", 0.0))
        within_one_ulp(got, ref)
    # the per-row form of the same call, as the decoder makes it
    los = start if W is None else np.maximum(start, lens - W)
    got = decode_attention_plain(t(q[:, 0]), t(k), t(v), t(lens), t(ks),
                                 t(vs), t(los.astype(np.int32)), ring=True,
                                 scale=opts.get("scale"),
                                 softcap=opts.get("softcap", 0.0))
    for b in range(B):
        ref_b = decode_attention_plain(
            t(q[b:b + 1, 0]), t(k[b:b + 1]), t(v[b:b + 1]), int(lens[b]),
            t(None if ks is None else ks[b:b + 1]),
            t(None if vs is None else vs[b:b + 1]), int(los[b]), ring=True,
            scale=opts.get("scale"), softcap=opts.get("softcap", 0.0))
        assert torch.equal(got[b:b + 1], ref_b)


@pytest.mark.parametrize("ring", [False, True])
def test_row_without_valid_position_is_uniform_as_in_jax(ring):
    """start >= length: every score is masked to -1e30, so JAX's softmax is
    uniform over all S slots and the row is the mean of v_scale * v over
    them; the plain version gives the same."""
    q, k, v, ks, vs = _ring_case(2, 8, 4, 2, 32, True, 5,
                                 np.array([11, 11], np.int32))
    ref = j_attend(q, k, v, jnp.asarray([10]), jnp.asarray(11),
                   jnp.asarray([11, 3], jnp.int32), k_scale=ks, v_scale=vs,
                   ring=ring)[:, 0]
    got = decode_attention_plain(t(q[:, 0]), t(k), t(v), 11, t(ks), t(vs),
                                 t(np.array([11, 3], np.int32)), ring=ring)
    within_one_ulp(got, ref)
    mean = (np.asarray(vs, np.float32)[0, :, :, None]
            * np.asarray(v, np.float32)[0]).mean(0)          # [n_kv, D]
    np.testing.assert_allclose(got[0].float().numpy().reshape(2, 2, 32),
                               np.repeat(mean[:, None], 2, 1), rtol=1e-2,
                               atol=1e-3)


def test_tolerance_pins_the_widened_recipe():
    """At Mistral-7B's heads (32/8, D=128) and a decode-like length, the
    int8 recipe of kernel 3 (q and p quantized to int8) on the same cache
    lies more than 1.5x DECODE_ATOL beyond two bf16 ulps of the widened
    recipe, so the card's limit tells the two apart."""
    B, S, n_q, n_kv, D = 4, 512, 32, 8, 128
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(0, 1, (B, n_q, D)).astype(
        np.float32)).to(torch.bfloat16)
    from mixq_tpu_torch.ops import quant as Q
    k, ks = Q.quantize_kv(torch.from_numpy(
        rng.normal(0, 1, (B, S, n_kv, D)).astype(np.float32)))
    v, vs = Q.quantize_kv(torch.from_numpy(
        rng.normal(0, 1, (B, S, n_kv, D)).astype(np.float32)))
    lens = torch.from_numpy(rng.integers(S // 2, S + 1, B).astype(np.int32))
    ref = decode_attention_plain(q, k, v, lens, ks, vs)
    hm = lambda x: x.permute(2, 0, 1, 3) if x.dim() == 4 else x.permute(
        2, 0, 1)
    wrong = flash_decode_plain(q, hm(k), hm(v), lens, hm(ks), hm(vs),
                               scale=float(D ** -0.5))
    over = ((wrong.float() - ref.float()).abs()
            - 2 * BF16_ULP * ref.float().abs()).max().item()
    assert over > 1.5 * DECODE_ATOL, over


def test_wrapper_refusals():
    q, k, v, ks, vs = setup(kv_dtype=jnp.int8)
    args = (t(q[:, 0]), t(k), t(v), 20, t(ks), t(vs))
    # ALiBi with a softcap: the kernel caps scores after their max
    with pytest.raises(ValueError, match="ALiBi with a softcap"):
        decode_attention(*args, softcap=30.0, alibi_slopes=torch.ones(4))
    with pytest.raises(ValueError):
        decode_attention(*args, softcap=-1.0)
    before = decode_attention.launches
    decode_attention(*args)
    assert decode_attention.launches == before    # the CPU runs the plain
