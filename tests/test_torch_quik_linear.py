"""PyTorch port: QUIK linears (ops/mixed_linear.py::quik_linear and
from_float's QUIK branch) against mixq_tpu/ops/mixed_linear.py on the CPU.

- from_float: W4A4 (packed W4) and W8A8 QUIK params, with and without an
  outlier set and a bias, bit-equal to JAX's carried over by convert.py
  (reduced_w summed over the unpacked values: JAX's
  tests/test_mix_gemm.py:222-233).
- quik_linear against JAX's on the same params and input, mirroring
  tests/test_mixed_linear.py:129-147 (W4A4 with two outlier channels, W8A8
  with one; f32 and bf16 inputs; a bias; SiLU; leading axes): the
  quantization and the integer GEMM are bit-equal, and the outputs agree
  within one bf16 ulp of each output plus 1e-6 of max|y| (the f32 outlier
  dot sums in another order, and a bf16 output may round the other way).
  Both track the fp linear as JAX's tests hold it (rel. error 0.15 / 0.02).
- mixed_linear dispatches QUIK specs to quik_linear.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu_torch import convert
from mixq_tpu_torch.ops import mixed_linear as TML
from mixq_tpu_torch.ops import quant as TQ

# mixq_tpu.ops exports a function of the module's name
JML = importlib.import_module("mixq_tpu.ops.mixed_linear")

ULP = 2.0 ** -8             # one bf16 ulp, relative
ABS = 1e-6                  # of max|y|


def data(seed, M, K, N, outliers=(), scale=30.0):
    r = np.random.RandomState(seed)
    x = r.randn(M, K).astype(np.float32)
    w = (r.randn(K, N) * 0.05).astype(np.float32)
    for c in outliers:
        x[:, c] *= scale
    return x, w


def both_params(w, spec_kw, outliers, K, budget, bias=None):
    jspec = JML.LinearSpec(version="QUIK", **spec_kw)
    tspec = TML.LinearSpec(version="QUIK", **spec_kw)
    joset = toset = None
    if outliers:
        joset = JQ.outlier_set_from_indices(jnp.array(outliers), k=K,
                                            budget=budget)
        toset = TQ.outlier_set_from_indices(list(outliers), K, budget,
                                            device="cpu")
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    jp = JML.from_float(jnp.asarray(w), jspec, bias=jb, outlier_set=joset)
    tp = TML.from_float(torch.from_numpy(w), tspec, bias=tb,
                        outlier_set=toset)
    return jp, tp, jspec, tspec


def assert_params_equal(jp, tp):
    ref = convert._linear(jax.tree.map(np.asarray, jp), "cpu")
    for f in TML.MixLinearParams._fields:
        a, b = getattr(tp, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a.view(torch.uint8) if a.dtype
                               == torch.bfloat16 else a,
                               b.view(torch.uint8) if b.dtype
                               == torch.bfloat16 else b), f


CASES = {
    "w4a4": (dict(w_bit=4, a_bit=4), (5, 11), 16),
    "w8a8": (dict(w_bit=8, a_bit=8), (3,), 16),
    "w4a4_no_outliers": (dict(w_bit=4, a_bit=4), (), 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("with_bias", [False, True])
def test_from_float_bit_equal(case, with_bias):
    spec_kw, outliers, budget = CASES[case]
    x, w = data(1, 8, 64, 32)
    bias = (np.random.RandomState(3).randn(32).astype(np.float32)
            if with_bias else None)
    jp, tp, _, _ = both_params(w, spec_kw, outliers, 64, budget, bias)
    assert tp.reduced_w is not None and tp.reduced_w.dtype == torch.float32
    if spec_kw["w_bit"] == 4:
        assert tp.q_weight.dtype == torch.uint8 and tp.q_weight.shape == (
            32, 32)
        # the sums of the values, not of the packed bytes
        assert torch.equal(tp.reduced_w, TQ.unpack_int4(
            tp.q_weight).int().sum(0).float())
    assert_params_equal(jp, tp)


def close(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    tol = ULP * np.abs(want) + ABS * np.abs(want).max()
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize("case,dtype,fuse,with_bias", [
    ("w4a4", "float32", "none", False),
    ("w4a4", "bfloat16", "silu", False),
    ("w4a4", "bfloat16", "silu", True),
    ("w8a8", "float32", "none", False),
    ("w8a8", "bfloat16", "none", True),
    ("w4a4_no_outliers", "bfloat16", "none", False),
])
def test_quik_linear_matches_jax(case, dtype, fuse, with_bias):
    spec_kw, outliers, budget = CASES[case]
    x, w = data(0, 8, 64, 32, outliers)
    bias = (np.random.RandomState(4).randn(32).astype(np.float32)
            if with_bias else None)
    jp, tp, jspec, tspec = both_params(w, {**spec_kw, "fuse": fuse},
                                       outliers, 64, budget, bias)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JML.mixed_linear(jp, jx, jspec)
    got = TML.mixed_linear(tp, tx, tspec)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (8, 32)
    close(got, want)


def test_quik_linear_leading_axes():
    spec_kw, outliers, budget = CASES["w4a4"]
    x, w = data(2, 12, 64, 32, outliers)
    jp, tp, jspec, tspec = both_params(w, spec_kw, outliers, 64, budget)
    x3 = x.reshape(3, 4, 64)
    want = JML.quik_linear(jp, jnp.asarray(x3).astype(jnp.bfloat16), jspec)
    got = TML.quik_linear(tp, torch.from_numpy(x3).bfloat16(), tspec)
    assert tuple(got.shape) == (3, 4, 32)
    close(got, want)


@pytest.mark.parametrize("case,limit", [("w4a4", 0.15), ("w8a8", 0.02)])
def test_quik_tracks_the_fp_linear(case, limit):
    """tests/test_mixed_linear.py::TestQUIK's accuracy bounds."""
    spec_kw, outliers, budget = CASES[case]
    M, K, N = (8, 64, 32) if case == "w4a4" else (16, 128, 64)
    x, w = data(6, M, K, N, outliers)
    _, tp, _, tspec = both_params(w, spec_kw, outliers, K, budget)
    y = TML.mixed_linear(tp, torch.from_numpy(x), tspec).float().numpy()
    ref = x @ w
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < limit


def test_mixed_linear_dispatches_quik():
    spec_kw, outliers, budget = CASES["w8a8"]
    x, w = data(7, 4, 64, 32, outliers)
    _, tp, _, tspec = both_params(w, spec_kw, outliers, 64, budget)
    tx = torch.from_numpy(x).bfloat16()
    assert torch.equal(TML.mixed_linear(tp, tx, tspec),
                       TML.quik_linear(tp, tx, tspec))
    mix = dataclasses.replace(tspec, version="MIX")
    assert not torch.equal(TML.mixed_linear(tp, tx, mix),
                           TML.quik_linear(tp, tx, tspec))
