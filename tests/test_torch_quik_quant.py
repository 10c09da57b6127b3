"""PyTorch port: QUIK's quantization primitives and the zero-point GEMM
against mixq_tpu on the CPU.

- `quantize_act_asymmetric` bit-equal to JAX's (q, scale, zero) at 4 and 8
  bits, on rows that reach the range's low end (-8, -128, which the
  symmetric quantizer never gives), rows of zeros (every channel an
  outlier: scale 1e-8, zero 2^(b-1)) and constant rows.
- `reduced_weight_rowsum` bit-equal on W8 and on packed W4 (unpacked
  first).
- `mix_gemm_plain` in its zero-point mode held to JAX's quik_linear
  arithmetic (mixq_tpu/ops/mixed_linear.py:341-351) on the same integers:
  bit-equal without outliers, and within 1e-6 of max|y| with an outlier
  term (an f32 dot of bf16 values, summed in another order), with a bias
  and SiLU; the wrapper on CPU tensors is its plain version; grouped
  scales with a zero point raise, as JAX refuses QUIK groups.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu_torch.kernels.mix_gemm import mix_gemm, mix_gemm_plain
from mixq_tpu_torch.ops import quant as TQ

OUTLIER_TOL = 1e-6          # of max|y|: the f32 outlier dot's sum order


def rows(seed, M, K):
    """[M, K] f32 rows: gaussian, one shifted positive (its minimum sets
    the zero point), one all zeros, one constant, one with a lone large
    negative channel (the low end of the range)."""
    r = np.random.RandomState(seed)
    x = r.randn(M, K).astype(np.float32)
    x[1] += 5.0
    x[2] = 0.0
    x[3] = 0.75
    x[4, 7] = -40.0
    return x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_asymmetric_quant_bit_equal(bits, dtype):
    x = rows(bits, 9, 96)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js, jz = JQ.quantize_act_asymmetric(jx, bits=bits)
    tq, ts, tz = TQ.quantize_act_asymmetric(tx, bits=bits)
    assert tq.dtype == torch.int8 and ts.shape == tz.shape == (9, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    lo = -(2 ** (bits - 1))
    q = tq.numpy()
    assert q.min() == lo and q.max() <= -lo - 1
    assert (q[4] == lo).sum() >= 1                 # the lone negative
    assert (q[2] == lo).all()                      # a row of zeros
    assert ts[2].item() == np.float32(1e-8) and tz[2].item() == -lo
    assert tz[1].item() != round(tz[1].item())     # not an integer


def test_asymmetric_quant_leading_axes():
    x = rows(3, 12, 64).reshape(3, 4, 64)
    jq, js, jz = JQ.quantize_act_asymmetric(jnp.asarray(x), bits=4)
    tq, ts, tz = TQ.quantize_act_asymmetric(torch.from_numpy(x), bits=4)
    assert tuple(ts.shape) == (3, 4, 1)
    for t, j in ((tq, jq), (ts, js), (tz, jz)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("w4", [False, True])
def test_reduced_weight_rowsum_bit_equal(w4):
    r = np.random.RandomState(5)
    lo, hi = (-8, 8) if w4 else (-127, 128)
    q = r.randint(lo, hi, (64, 48)).astype(np.int8)
    tq = torch.from_numpy(q)
    if w4:                          # through the packed storage
        tq = TQ.unpack_int4(TQ.pack_int4(tq))
    got = TQ.reduced_weight_rowsum(tq)
    want = JQ.reduced_weight_rowsum(jnp.asarray(q))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def jax_quik(q_x, x_scale, x_zero, q_w, w_scale, reduced_w, x_out=None,
             w_out=None, bias=None, fuse="none"):
    """JAX's quik_linear after its quantization, op by op."""
    acc = jax.lax.dot_general(
        jnp.asarray(q_x), jnp.asarray(q_w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32).astype(jnp.float32)
    corr = jnp.asarray(x_zero) * jnp.asarray(reduced_w)[None, :]
    y = jnp.asarray(x_scale) * jnp.asarray(w_scale)[None, :] * (acc + corr)
    if x_out is not None:
        y = y + jnp.dot(jnp.asarray(x_out).astype(jnp.float32),
                        jnp.asarray(w_out).astype(jnp.float32),
                        preferred_element_type=jnp.float32)
    if bias is not None:
        y = y + jnp.asarray(bias).astype(jnp.float32)
    if fuse == "silu":
        y = jax.nn.silu(y)
    return np.asarray(y, np.float32)


def zp_operands(seed, M, K, N, bits, Bo=0):
    r = np.random.RandomState(seed)
    x = rows(seed, M, K)
    q_x, x_scale, x_zero = (t.numpy() for t in TQ.quantize_act_asymmetric(
        torch.from_numpy(x), bits=bits))
    lo, hi = (-8, 8) if bits == 4 else (-127, 128)
    q_w = r.randint(lo, hi, (K, N)).astype(np.int8)
    w_scale = (r.rand(N) * 1e-2 + 1e-3).astype(np.float32)
    rw = TQ.reduced_weight_rowsum(torch.from_numpy(q_w)).numpy()
    out = None
    if Bo:
        xo = torch.from_numpy(r.randn(M, Bo).astype(np.float32)).bfloat16()
        wo = torch.from_numpy(r.randn(Bo, N).astype(np.float32)
                              * 0.05).bfloat16()
        out = (xo, wo)
    return q_x, x_scale, x_zero, q_w, w_scale, rw, out


def port_zp(q_x, x_scale, x_zero, q_w, w_scale, rw, out, w4, fuse="none",
            out_dtype=torch.float32, fn=mix_gemm_plain):
    w = torch.from_numpy(q_w)
    if w4:
        w = TQ.pack_int4(w)
    xo, wo = out if out else (None, None)
    return fn(torch.from_numpy(q_x), w, torch.from_numpy(x_scale),
              torch.from_numpy(w_scale), xo, wo, fuse=fuse,
              out_dtype=out_dtype, x_zero=torch.from_numpy(x_zero),
              reduced_w=torch.from_numpy(rw))


@pytest.mark.parametrize("bits,w4", [(4, True), (8, False)])
def test_zero_point_gemm_bit_equal_to_jax(bits, w4):
    ops = zp_operands(bits, 9, 128, 48, bits)
    got = port_zp(*ops, w4=w4)
    want = jax_quik(*ops[:6])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits,w4", [(4, True), (8, False)])
def test_zero_point_gemm_outliers_bias_silu(bits, w4):
    q_x, xs, xz, q_w, ws, rw, (xo, wo) = zp_operands(11 + bits, 9, 128, 48,
                                                     bits, Bo=16)
    bias = torch.from_numpy(np.random.RandomState(2).randn(48).astype(
        np.float32)).bfloat16()
    # the port's linear adds a bias to the f32 result, then the epilogue
    y = port_zp(q_x, xs, xz, q_w, ws, rw, (xo, wo), w4)
    got = torch.nn.functional.silu(y + bias.float())
    want = jax_quik(q_x, xs, xz, q_w, ws, rw, xo.float().numpy(),
                    wo.float().numpy(), bias.float().numpy(), fuse="silu")
    tol = OUTLIER_TOL * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    fused = port_zp(q_x, xs, xz, q_w, ws, rw, (xo, wo), w4, fuse="silu")
    want_nb = jax_quik(q_x, xs, xz, q_w, ws, rw, xo.float().numpy(),
                       wo.float().numpy(), fuse="silu")
    np.testing.assert_allclose(fused.numpy(), want_nb, rtol=0,
                               atol=OUTLIER_TOL * np.abs(want_nb).max())


def test_wrapper_on_cpu_is_the_plain_version():
    ops = zp_operands(4, 9, 128, 48, 4, Bo=16)
    a = port_zp(*ops, w4=True, fuse="silu", out_dtype=torch.bfloat16)
    b = port_zp(*ops, w4=True, fuse="silu", out_dtype=torch.bfloat16,
                fn=mix_gemm)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_zero_point_needs_both_operands_and_per_channel_scales():
    q_x = torch.zeros((2, 32), dtype=torch.int8)
    w = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="both"):
        mix_gemm(q_x, w, torch.ones(2, 1), torch.ones(16),
                 x_zero=torch.ones(2, 1))
    with pytest.raises(ValueError, match="QUIK"):
        mix_gemm(q_x, w, torch.ones(2, 1), torch.ones(2, 16),
                 x_zero=torch.ones(2, 1), reduced_w=torch.ones(16))
