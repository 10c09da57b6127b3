"""PyTorch port, kernel A (kernels/mix_gemm.py in its packed-W4 and grouped
modes) on the CPU: its plain version against the Pallas
mix_gemm(interpret=True) on the cases of tests/test_mix_gemm.py (packed W4,
W8 and W4 grouped, W4 grouped with outliers and SiLU), and the port's
mixed_linear against JAX's on W4 / grouped params made by JAX's from_float
and carried by convert, which the port's own from_float repeats bit for
bit.

Tolerance: f32 outputs agree to rtol = atol = 1e-5, and grouped ones to
that plus G f32 ulps of S = x_scale * sum_g |float(acc_g) * w_scale[g]|.
The int32 (per-group) accumulators are exact on both sides; what differs is
the order of the f32 sum over groups (whose terms can cancel, so its error
scales with S, not |y|) and the outlier dot's summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec as JLS
from mixq_tpu.ops.mixed_linear import from_float as j_from_float
from mixq_tpu.ops.mixed_linear import mixed_linear as j_mixed_linear
from mixq_tpu.ops.pallas.mix_gemm import mix_gemm as j_mix_gemm
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.mix_gemm import mix_gemm
from mixq_tpu_torch.ops import mixed_linear as TML
from mixq_tpu_torch.ops import quant as TQ

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _operands(M, K, N, G, B, w4, seed):
    rng = np.random.default_rng(seed)
    q_x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    q_w = (rng.integers(-8, 8, (K, N)) if w4
           else rng.integers(-127, 128, (K, N))).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (G, N) if G else (N,)).astype(np.float32)
    xo = wo = None
    if B:
        xo = np.asarray(jnp.asarray(rng.normal(0, 1, (M, B)), jnp.bfloat16))
        wo = np.asarray(jnp.asarray(rng.normal(0, 1, (B, N)), jnp.bfloat16))
    w = np.asarray(JQ.pack_int4(jnp.asarray(q_w))) if w4 else q_w
    return q_x, w, xs, ws, xo, wo


def _group_sum_atol(ops):
    """G f32 ulps (2**-23) of x_scale * sum_g |float(acc_g) * w_scale[g]|."""
    q_x, w, xs, ws = ops[:4]
    if ws.ndim == 1:
        return 0.0
    wv = np.asarray(TQ.unpack_int4(t(w))) if w.dtype == np.uint8 else w
    G, M, K = ws.shape[0], q_x.shape[0], q_x.shape[1]
    acc = np.einsum("mgk,gkn->gmn", q_x.reshape(M, G, K // G).astype(
        np.float64), wv.reshape(G, K // G, -1).astype(np.float64))
    S = np.abs(acc * ws[:, None, :]).sum(0) * xs
    return G * 2.0 ** -23 * S


def _both(ops, **kw):
    j = j_mix_gemm(*[None if a is None else jnp.asarray(a) for a in ops],
                   out_dtype=jnp.float32, interpret=True, **kw)
    p = mix_gemm(*[None if a is None else t(a) for a in ops],
                 out_dtype=torch.float32, **kw)
    return np.asarray(j), p.numpy()


@pytest.mark.parametrize("M", [1, 48])
def test_w4_packed(M):
    j, p = _both(_operands(M, 512, 384, 0, 0, True, M))
    np.testing.assert_allclose(p, j, **TOL)


def _assert_grouped_close(ops, **kw):
    j, p = _both(ops, **kw)
    np.testing.assert_array_less(np.abs(p - j), 1e-5 * np.abs(j) + 1e-5
                                 + _group_sum_atol(ops))


@pytest.mark.parametrize("M,K,N,G", [(1, 256, 384, 8), (33, 512, 256, 4)])
def test_w8_grouped(M, K, N, G):
    _assert_grouped_close(_operands(M, K, N, G, 0, False, K))


@pytest.mark.parametrize("fuse", ["none", "silu"])
def test_w4_grouped(fuse):
    _assert_grouped_close(_operands(16, 512, 384, 4, 0, True, 11), fuse=fuse)


@pytest.mark.parametrize("fuse", ["none", "silu"])
def test_w4_grouped_outlier(fuse):
    _assert_grouped_close(_operands(8, 256, 256, 8, 16, True, 12), fuse=fuse)


@pytest.mark.parametrize("w_bit,group,fuse", [(4, -1, "none"),
                                              (4, -1, "silu"),
                                              (4, 64, "silu"),
                                              (8, 32, "none")])
def test_vs_mixed_linear(w_bit, group, fuse):
    """JAX's mixed_linear (prepare_act at a_bit = w_bit, int_weight unpack,
    XLA dot, grouped epilogue) against the port's, on JAX-quantized params
    with 8 planted outlier channels of a budget of 16."""
    rng = np.random.default_rng(w_bit + group)
    M, K, N, budget = 9, 256, 192, 16
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    x[:, 3] *= 40.0
    kw = dict(w_bit=w_bit, a_bit=w_bit, fuse=fuse, out_dtype="float32",
              group_size=group)
    oset = JQ.outlier_set_from_indices(
        np.sort(rng.choice(K, 8, replace=False)), K, budget)
    jp = j_from_float(jnp.asarray(w), JLS(**kw), outlier_set=oset)
    if w_bit == 4:
        assert jp.q_weight.dtype == jnp.uint8        # JAX stores it packed
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = j_mixed_linear(jp, xb, JLS(**kw))
    tp = TML.MixLinearParams(*[None if a is None else t(a)
                               for a in jax.tree.map(np.asarray, jp)])
    got = TML.mixed_linear(tp, t(xb), TML.LinearSpec(**kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mine = TML.from_float(t(w), TML.LinearSpec(**kw), outlier_set=(
        TQ.outlier_set_from_indices(np.asarray(oset.ind)[:8], K, budget,
                                    device="cpu")))
    for a, b in zip(tp, mine):
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.float().numpy())
    spec = TML.LinearSpec(**kw)
    np.testing.assert_array_equal(
        TML.int_weight(mine, spec).numpy(),
        np.asarray(JQ.unpack_int4(jp.q_weight) if w_bit == 4
                   else jp.q_weight))


def test_mix_gemm_dispatches_a16_on_a_bf16_activation():
    """A bf16 activation is the weight-only mode (kernel B), as the Pallas
    kernel dispatches on dtypes."""
    q_x, w, _, ws, _, _ = _operands(4, 64, 32, 0, 0, True, 3)
    x = t(np.asarray(jnp.asarray(q_x / 50.0, jnp.bfloat16)))
    got = mix_gemm(x, t(w), None, t(ws), out_dtype=torch.float32)
    j = j_mix_gemm(jnp.asarray(np.asarray(x.float())).astype(jnp.bfloat16),
                   jnp.asarray(w), None, jnp.asarray(ws),
                   out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(j)).max())
