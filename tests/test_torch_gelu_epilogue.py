"""PyTorch port, the gelu and gelu_new epilogues of kernels 2, A and B on
the CPU: the plain versions (mix_gemm_plain in its W8A8, packed-W4 and
grouped modes, w8a16_plain in its a16 modes) against the Pallas
mix_gemm(interpret=True), which applies jax.nn.gelu, and the shared plain
epilogue against jax.nn.gelu itself.

The plain epilogue repeats jax.nn.gelu's order of operations and constants.
What differs is the transcendental: XLA's CPU tanh is a fast approximation
(up to ~3e-7 relative, against torch's and CUDA's ~1e-7), and erfc is
computed another way, so an f32 result can differ by a few f32 ulps; after
the cancellation in 1 + tanh(u) for large negative y that is an absolute
error of a few f32 ulps of the cdf's 1 times |y|. Tolerance: one bf16 ulp of
|y| (a bf16 output whose rounding those ulps flip) plus 2**-20 * max|y| for
the cancellation near y = 0 of the cdf, and for grouped scales the G f32
ulps of S = x_scale * sum_g |float(acc_g) * w_scale[g]| that
tests/test_torch_w4_gemm.py allows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.mix_gemm import mix_gemm as j_mix_gemm
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels._build import apply_epilogue
from mixq_tpu_torch.kernels.mix_gemm import mix_gemm
from mixq_tpu_torch.ops import quant as TQ

BF16_ULP = 2.0 ** -7
# name: (M, K, N, G, outlier budget, packed W4, bf16 activation (a16))
CASES = {
    "w8a8": (16, 256, 384, 0, 16, False, False),
    "w8a8_grouped": (9, 512, 256, 4, 0, False, False),
    "w4": (7, 512, 256, 0, 16, True, False),
    "w4_grouped": (8, 256, 256, 8, 16, True, False),
    "a16_w8": (12, 256, 384, 0, 16, False, True),
    "a16_w4_grouped": (5, 512, 256, 8, 0, True, True),
}


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _operands(M, K, N, G, B, w4, a16, seed):
    """Scales chosen so that y spans a few units either side of 0, where the
    two GELUs bend (larger |y| is y or 0 for both)."""
    rng = np.random.default_rng(seed)
    q_w = (rng.integers(-8, 8, (K, N)) if w4
           else rng.integers(-127, 128, (K, N))).astype(np.int8)
    w = np.asarray(JQ.pack_int4(jnp.asarray(q_w))) if w4 else q_w
    lo, hi = (0.02, 0.05) if w4 else (0.001, 0.003)
    ws = rng.uniform(lo, hi, (G, N) if G else (N,)).astype(np.float32)
    if a16:
        x = np.asarray(jnp.asarray(rng.normal(0, 1, (M, K)), jnp.bfloat16))
        xs = None
    else:
        qa = 7 if w4 else 127
        x = rng.integers(-qa, qa + 1, (M, K)).astype(np.int8)
        xs = rng.uniform(0.5, 1.5, (M, 1)).astype(np.float32) * (
            0.05 if w4 else 0.002)
    xo = wo = None
    if B:
        xo = np.asarray(jnp.asarray(rng.normal(0, 1, (M, B)), jnp.bfloat16))
        wo = np.asarray(jnp.asarray(rng.normal(0, 0.1, (B, N)),
                                    jnp.bfloat16))
    return x, w, xs, ws, xo, wo


def _group_sum_atol(x, w, xs, ws):
    """G f32 ulps of x_scale * sum_g |float(acc_g) * w_scale[g]| (int8
    activations with grouped scales only)."""
    if ws.ndim == 1 or xs is None:
        return 0.0
    wv = np.asarray(TQ.unpack_int4(t(w))) if w.dtype == np.uint8 else w
    G, (M, K) = ws.shape[0], x.shape
    acc = np.einsum("mgk,gkn->gmn",
                    x.reshape(M, G, K // G).astype(np.float64),
                    wv.reshape(G, K // G, -1).astype(np.float64))
    return G * 2.0 ** -23 * np.abs(acc * ws[:, None, :]).sum(0) * xs


@pytest.mark.parametrize("fuse", ["gelu", "gelu_new"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gelu_epilogue_vs_pallas(case, fuse):
    ops = _operands(*CASES[case], seed=len(case) + len(fuse))
    for out_dtype, j_dtype in ((torch.float32, jnp.float32),
                               (torch.bfloat16, jnp.bfloat16)):
        j = j_mix_gemm(*[None if a is None else jnp.asarray(a) for a in ops],
                       fuse=fuse, out_dtype=j_dtype, interpret=True)
        got = mix_gemm(*[None if a is None else t(a) for a in ops],
                       fuse=fuse, out_dtype=out_dtype)
        assert got.dtype == out_dtype
        j = np.asarray(j.astype(jnp.float32))
        tol = (BF16_ULP * np.abs(j) + 2.0 ** -20 * np.abs(j).max()
               + _group_sum_atol(*ops[:4]))
        np.testing.assert_array_less(np.abs(got.float().numpy() - j),
                                     tol + 1e-30)
    # y spans the bend: the epilogue is not the identity or a ReLU here
    none = mix_gemm(*[None if a is None else t(a) for a in ops],
                    out_dtype=torch.float32).numpy()
    assert (none < -0.5).any() and (none > 0.5).any()
    assert np.abs(got.float().numpy() - np.maximum(none, 0)).max() > 0.05


@pytest.mark.parametrize("fuse,approximate", [("gelu", False),
                                              ("gelu_new", True)])
def test_plain_epilogue_is_jax_nn_gelu(fuse, approximate):
    """On an f32 grid of inputs x over [-12, 12]: within 4 f32 ulps of the
    output plus 2e-7 (1 + |x|) (XLA's tanh error, ~3e-7 near -1, halved and
    carried by the cdf's cancellation for negative x, times |x|); after the
    bf16 cast the kernels apply, within one bf16 ulp and that."""
    y = np.linspace(-12, 12, 200_001, dtype=np.float32)
    j = np.asarray(jax.nn.gelu(jnp.asarray(y), approximate=approximate))
    got = apply_epilogue(torch.from_numpy(y), fuse).numpy()
    cancel = 2e-7 * (1 + np.abs(y))
    np.testing.assert_array_less(np.abs(got - j),
                                 4 * 2.0 ** -23 * np.abs(j) + cancel)
    # and the cast the kernels apply: one bf16 flip at most
    jb = np.asarray(jnp.asarray(j, jnp.bfloat16).astype(jnp.float32))
    gb = torch.from_numpy(got).bfloat16().float().numpy()
    np.testing.assert_array_less(np.abs(gb - jb),
                                 BF16_ULP * np.abs(jb) + cancel)
