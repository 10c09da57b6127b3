"""PyTorch port, kernel 2's launch plan and its split-K recipe on the CPU.

`kernels/mix_gemm.py::plan_mix` on every W8A8 linear shape the served
paths give kernel 2 (Llama-2-7B and Mistral-7B q/k/v/o, up/gate and down;
Gemma-2-9B q, k/v, o, up/gate and down; the W4A4 paths' o and down are the
same shapes), at decode (M = 1, 64) and prefill (M = 512), on 132 SMs, with
the H100's cluster occupancy and with the default one: at most 8 splits,
splits that cover K exactly on stage boundaries, every cluster on the card
at once, no split where the tiles alone fill the card.

The kernel's arithmetic with a plan's splits, emulated in PyTorch: each
split's int32 partial product, the partials summed (exact in any order),
converted to f32 once, scaled in JAX's order, then the outlier term, the
epilogue and the cast. Without outlier channels it is bit-equal to
`mix_gemm_plain` and to the Pallas mix_gemm and int8_matmul_dequant
(interpret=True) at several forced splits, uneven ones among them, on
numpy-seeded inputs; with outlier channels it is bit-equal to
`mix_gemm_plain` (the same f32 outlier product) and within
tests/test_torch_mix_gemm.py's 1e-5 of the Pallas kernel (the outlier dot
sums in another order there).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops.pallas.int8_matmul import int8_matmul_dequant as j_int8mm
from mixq_tpu.ops.pallas.mix_gemm import mix_gemm as j_mix_gemm
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.kernels.mix_gemm import KSTEP, mix_gemm_plain, plan_mix

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 132
# cudaOccupancyMaxActiveClusters of kernel 2's 8-warp blocks (4 stages of
# 128 K-rows: one block per SM) for clusters of 1..8 blocks on an NVIDIA
# H100 80GB HBM3, packed into the GPCs
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
# (K, N) of every W8A8 linear kernel 2 serves: Llama-2-7B and Mistral-7B
# q/o, k/v (Mistral), up/gate, down; Gemma-2-9B q, k/v, o, up/gate, down
SERVE_SHAPES = [(4096, 4096), (4096, 1024), (4096, 11008), (11008, 4096),
                (4096, 14336), (14336, 4096), (3584, 4096), (3584, 2048),
                (4096, 3584), (3584, 14336), (14336, 3584)]
FUSES = ["none", "silu", "gelu", "gelu_new"]


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def forced(M, N, K, S):
    """plan_mix (W8 per-channel) with S splits: a cluster table on which S
    is the largest split that fits."""
    tiles = -(-M // 64) * -(-N // 128)
    return plan_mix(M, N, K, False, 1, SMS, (tiles,) * S + (0,) * (8 - S))


@pytest.mark.parametrize("M", [1, 64, 512])
@pytest.mark.parametrize("K,N", SERVE_SHAPES)
def test_plan_on_serve_shapes(K, N, M):
    for clusters in (H100_CLUSTERS, None):
        p = plan_mix(M, N, K, False, 1, SMS, clusters)
        assert p.stage_rows == KSTEP == 128 and (p.bm, p.bn) == (64, 128)
        assert 1 <= p.splits <= 8 and len(p.bounds) == p.splits
        # the splits cover [0, K) in order, none empty, none overlapping,
        # each starting on a stage, their stage counts within one
        assert p.bounds[0][0] == 0 and p.bounds[-1][1] == K
        for (a, b), (c, _) in zip(p.bounds, p.bounds[1:]):
            assert b == c
        assert all(a < b and a % p.stage_rows == 0 for a, b in p.bounds)
        sizes = [-(-(b - a) // p.stage_rows) for a, b in p.bounds]
        assert max(sizes) - min(sizes) <= 1
        tiles = -(-M // p.bm) * -(-N // p.bn)
        assert p.blocks == tiles * p.splits
        slots = clusters or [SMS // s for s in range(1, 9)]
        # every cluster of the plan on the card at once (one wave)
        assert p.splits == 1 or tiles <= slots[p.splits - 1]
        # no larger split would still fit in one wave
        if p.splits < min(8, -(-K // p.stage_rows)):
            assert tiles > slots[p.splits]
        if tiles > slots[1]:                 # the tiles alone fill the card
            assert p.splits == 1


def test_plan_examples():
    """Plans at M = 64 on the H100 (N-tiles, splits): the largest split
    whose clusters all fit at once."""
    def tiles_splits(K, N):
        p = plan_mix(64, N, K, False, 1, SMS, H100_CLUSTERS)
        return -(-N // p.bn), p.splits

    assert tiles_splits(4096, 4096) == (32, 3)      # 4 would need 32 > 30
    assert tiles_splits(4096, 11008) == (86, 1)     # 2 would need 86 > 66
    assert tiles_splits(11008, 4096) == (32, 3)
    assert tiles_splits(4096, 14336) == (112, 1)
    assert tiles_splits(3584, 2048) == (16, 6)
    assert tiles_splits(14336, 3584) == (28, 4)
    assert tiles_splits(4096, 1024) == (8, 8)
    p = plan_mix(64, 4096, 11008, False, 1, SMS, H100_CLUSTERS)
    assert [-(-(b - a) // 128) for a, b in p.bounds] == [29, 29, 28]
    # prefill: 688 tiles fill the card alone
    assert plan_mix(512, 11008, 4096, False, 1, SMS,
                    H100_CLUSTERS).splits == 1
    # the forced plans of the tests below
    assert [(b - a) // 128 for a, b in forced(9, 256, 1040, 6).bounds] == [
        2, 2, 2, 1, 1, 0]
    assert forced(9, 256, 1040, 6).bounds[-1] == (1024, 1040)  # a K tail
    assert forced(9, 256, 272, 3).bounds[-1] == (256, 272)


def split_k_emulated(q_x, w, xs, ws, xo=None, wo=None, fuse="none",
                     out_dtype=torch.float32, splits=1):
    """Kernel 2's recipe with `splits` splits: per-split int32 partials
    (each held to int32's range), summed, converted to f32 once, times
    x_scale then w_scale, plus the outlier term, the epilogue, the cast.
    Returns the result and the plan."""
    M, K = q_x.shape
    plan = forced(M, w.shape[1], K, splits)
    assert plan.splits == splits
    acc = None
    for a, b in plan.bounds:
        part = q_x[:, a:b].long() @ w[a:b].long()
        assert part.abs().max() < 2 ** 31
        acc = part if acc is None else acc + part
    y = acc.to(torch.int32).float() * xs.reshape(-1, 1) * ws.reshape(1, -1)
    if xo is not None:
        y = y + torch.matmul(xo.float(), wo.float())
    return _build.apply_epilogue(y, fuse).to(out_dtype), plan


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


def _torch(ops):
    return [None if a is None else t(a) for a in ops]


def _bits(y):
    return np.asarray(y).view(np.uint32)


@pytest.mark.parametrize("K,splits", [(704, 1), (704, 4), (704, 6),
                                      (272, 3), (1040, 8)])
def test_split_k_recipe_bit_equal_to_pallas(K, splits):
    """No outlier channels: the same bits at every split, the uneven ones
    (704 = 5 stages and a 64-row tail over 4 or 6; 272 = 2 stages and a
    16-row tail over 3; 1040 = 8 stages and a 16-row tail over 8), as the
    Pallas mix_gemm and int8_matmul_dequant and as mix_gemm_plain."""
    ops = _operands(9, K, 256, 0, K + splits)
    got, _ = split_k_emulated(*_torch(ops), splits=splits)
    plain = mix_gemm_plain(*_torch(ops), out_dtype=torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    jops = [jnp.asarray(a) for a in ops[:4]]
    for fn in (j_mix_gemm, j_int8mm):
        j = fn(*jops, out_dtype=jnp.float32, interpret=True)
        np.testing.assert_array_equal(_bits(got), _bits(j))


@pytest.mark.parametrize("fuse", FUSES)
def test_split_k_recipe_epilogues(fuse):
    """Every epilogue, f32 and bf16 out, with and without outliers: bit-equal
    to mix_gemm_plain at S = 1, 3 and 4 (K = 464: 3 stages and an 80-row
    tail), and across those S; within 1e-5 of the Pallas mix_gemm (jax.nn's
    sigmoid, erfc and tanh are not torch's to the bit)."""
    for B, out_dtype in itertools.product(
            (0, 32), (torch.float32, torch.bfloat16)):
        ops = _operands(33, 464, 384, B, len(fuse) + B)
        runs = [split_k_emulated(*_torch(ops), fuse=fuse,
                                 out_dtype=out_dtype, splits=S)[0]
                for S in (1, 3, 4)]
        plain = mix_gemm_plain(*_torch(ops), fuse=fuse, out_dtype=out_dtype)
        for r in runs:
            assert torch.equal(r.view(torch.uint8), plain.view(torch.uint8))
    ops = _operands(33, 464, 384, 32, len(fuse))
    j = j_mix_gemm(*[jnp.asarray(a) for a in ops], fuse=fuse,
                   out_dtype=jnp.float32, interpret=True)
    got, _ = split_k_emulated(*_torch(ops), fuse=fuse, splits=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), **TOL)


def test_split_k_recipe_with_outliers_vs_pallas_int8_matmul():
    """int8_matmul_dequant's contract with 48 outlier channels and SiLU, K =
    1040 (9 stages) split 8 ways: within 1e-5 of the Pallas kernel."""
    ops = _operands(17, 1040, 384, 48, 3)
    got, _ = split_k_emulated(*_torch(ops), fuse="silu", splits=8)
    j = j_int8mm(*[jnp.asarray(a) for a in ops], fuse="silu",
                 out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), **TOL)


def test_int32_range_of_the_serve_shapes():
    """The reduction is exact: |acc| <= 127 * 127 * K stays inside int32 for
    every K the served paths give kernel 2 (the largest, 14336: 2.3e8)."""
    assert max(K for K, _ in SERVE_SHAPES) * 127 * 127 < 2 ** 31
