"""PyTorch port, kernel 2 (kernels/mix_gemm.py) on the CPU: its plain
version against the Pallas mix_gemm(interpret=True) at the shapes of
tests/test_mix_gemm.py, against the JAX main path
(prepare_act + mixed_linear_prepared), and `int8_matmul_dequant` against
the Pallas int8_matmul kernel on the cases of tests/test_pallas_kernels.py.
f32 outputs agree to rtol = atol = 1e-5: the int32 accumulator is exact on
both sides and only the outlier dot's summation order differs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec as JLS
from mixq_tpu.ops.mixed_linear import from_float as j_from_float
from mixq_tpu.ops.mixed_linear import mixed_linear as j_mixed_linear
from mixq_tpu.ops.pallas.int8_matmul import int8_matmul_dequant as j_int8mm
from mixq_tpu.ops.pallas.mix_gemm import mix_gemm as j_mix_gemm
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels.mix_gemm import int8_matmul_dequant, mix_gemm
from mixq_tpu_torch.ops import mixed_linear as TML
from mixq_tpu_torch.ops import quant as TQ

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _operands(M, K, N, B, seed):
    rng = np.random.default_rng(seed)
    q_x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    q_w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (N,)).astype(np.float32)
    xo = wo = None
    if B:
        xo = np.asarray(jnp.asarray(rng.normal(0, 1, (M, B)), jnp.bfloat16))
        wo = np.asarray(jnp.asarray(rng.normal(0, 1, (B, N)), jnp.bfloat16))
    return q_x, q_w, xs, ws, xo, wo


def _both(fn_j, fn_t, ops, **kw):
    j = fn_j(*[None if a is None else jnp.asarray(a) for a in ops],
             out_dtype=jnp.float32, interpret=True, **kw)
    p = fn_t(*[None if a is None else t(a) for a in ops],
             out_dtype=torch.float32, **kw)
    return np.asarray(j), p.numpy()


@pytest.mark.parametrize("M,K,N", [(1, 256, 384), (7, 512, 256),
                                   (64, 256, 640)])
@pytest.mark.parametrize("fuse", ["none", "silu"])
def test_plain_vs_pallas(M, K, N, fuse):
    j, p = _both(j_mix_gemm, mix_gemm, _operands(M, K, N, 0, M + K), fuse=fuse)
    np.testing.assert_allclose(p, j, **TOL)


@pytest.mark.parametrize("fuse", ["none", "silu"])
def test_plain_vs_pallas_outlier(fuse):
    j, p = _both(j_mix_gemm, mix_gemm, _operands(33, 384, 256, 32, 1),
                 fuse=fuse)
    np.testing.assert_allclose(p, j, **TOL)


@pytest.mark.parametrize("fuse", ["none", "silu"])
@pytest.mark.parametrize("n_out,bias", [(0, False), (12, False), (12, True)])
def test_vs_mixed_linear_prepared(fuse, n_out, bias):
    """The JAX main path's linear (prepare_act + XLA int8 dot + epilogue)
    against the port's, on weights quantized by JAX and converted."""
    rng = np.random.default_rng(n_out + len(fuse))
    M, K, N, budget = 9, 256, 192, 16
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    x[:, 3] *= 40.0
    b = jnp.asarray(rng.normal(0, 1, (N,)).astype(np.float32)) if bias else None
    spec = JLS(w_bit=8, a_bit=8, fuse=fuse, out_dtype="float32")
    oset = (JQ.outlier_set_from_indices(
        np.sort(rng.choice(K, n_out, replace=False)), K, budget)
        if n_out else None)
    jp = j_from_float(jnp.asarray(w), spec, bias=b, outlier_set=oset)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = j_mixed_linear(jp, xb, spec)
    tp = TML.MixLinearParams(*[None if a is None else t(a)
                               for a in jax.tree.map(np.asarray, jp)])
    tspec = TML.LinearSpec(w_bit=8, a_bit=8, fuse=fuse, out_dtype="float32")
    got = TML.mixed_linear(tp, t(xb), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the port's own from_float builds the same params from the same weight
    toset = (TQ.outlier_set_from_indices(np.asarray(oset.ind)[:n_out], K,
                                         budget, device="cpu")
             if n_out else None)
    mine = TML.from_float(t(w), tspec, bias=None if b is None else t(b),
                          outlier_set=toset)
    for a, b in zip(tp, mine):
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.float().numpy(),
                                          b.float().numpy())


def _pk_inputs(M=64, K=128, N=96, key=0):
    """tests/test_pallas_kernels.py::make_quant_inputs."""
    kx, kw = jax.random.split(jax.random.PRNGKey(key))
    x = jax.random.normal(kx, (M, K))
    w = jax.random.normal(kw, (K, N)) * 0.05
    qx, xs = JQ.quantize_act_per_token(x)
    qw, ws = JQ.quantize_weight_int8(w)
    return [np.asarray(a) for a in (qx, qw, xs, ws)]


@pytest.mark.parametrize("case", ["reference", "silu", "outlier",
                                  "unaligned"])
def test_int8_matmul_dequant_vs_pallas(case):
    kw = {}
    if case == "unaligned":
        ops = _pk_inputs(M=33, K=128, N=70, key=5)
    else:
        ops = _pk_inputs(key={"reference": 0, "silu": 1, "outlier": 2}[case])
    if case == "silu":
        kw["fuse"] = "silu"
    if case == "outlier":
        xo = jax.random.normal(jax.random.PRNGKey(3), (64, 16)
                               ).astype(jnp.bfloat16)
        wo = (jax.random.normal(jax.random.PRNGKey(4), (16, 96)) * 0.05
              ).astype(jnp.bfloat16)
        ops += [np.asarray(xo), np.asarray(wo)]
    j, p = _both(j_int8mm, int8_matmul_dequant, ops, **kw)
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, **TOL)


def test_unported_modes_raise():
    q_x = torch.zeros((2, 32), dtype=torch.int8)
    w = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        mix_gemm(q_x, w, torch.ones(2, 1), torch.ones(16), fuse="relu")
    with pytest.raises(NotImplementedError):
        TML.from_float(torch.zeros(32, 16),
                       TML.LinearSpec(w_bit=4, version="QUIK"))
    spec = dataclasses.replace(TML.LinearSpec(), version="QUIK")
    with pytest.raises(NotImplementedError):
        TML.mixed_linear(TML.MixLinearParams(w, torch.ones(16)),
                         torch.zeros(2, 32), spec)
