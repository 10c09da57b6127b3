"""PyTorch port, kernel B's launch plan and its split-K recipe on the CPU.

`kernels/w8a16.py::plan_a16` on every linear shape the Llama-2-7B and
Gemma-2-9B serve paths give kernel B, at decode (M = 1, 64) and prefill
(M = 512), W8 and W4, per-channel and grouped, on 132 SMs, with the
H100's cluster occupancy and with the default one: at most 8 splits,
splits that cover the stored rows exactly on stage boundaries, every
cluster on the card at once, at least 132 blocks where the tiles and
splits allow it, no split where the tiles alone fill the card twice.

The kernel's arithmetic with the plan's splits, emulated in PyTorch: each
split's partial product in f32, the partials summed in split order, then
the outlier term, the epilogue and the cast. It is held to `w8a16_plain`
and to the Pallas mix_gemm / w8a16_matmul (interpret=True) on the same
numpy-seeded inputs under tests/test_torch_w8a16.py's limit, 1e-6 *
(|x| @ |wd|): splitting K changes only the f32 summation order.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.mix_gemm import mix_gemm as j_mix_gemm
from mixq_tpu.ops.pallas.w8a16 import w8a16_matmul as j_w8a16_matmul
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.kernels.w8a16 import (MAX_SPLITS, dequant_weight,
                                          plan_a16, w8a16_plain)

RTOL_S = 1e-6
SMS = 132
# cudaOccupancyMaxActiveClusters of kernel B's 8-warp, 4-stage blocks for
# clusters of 1..8 blocks on an NVIDIA H100 80GB HBM3 (every weight mode
# the same; two blocks per SM, packed into the GPCs)
H100_CLUSTERS = (264, 132, 79, 62, 47, 39, 32, 30)
# (K, N) of every linear kernel B serves: Llama-2-7B q/k/v/o, up/gate,
# down; Gemma-2-9B q, k/v, o, up/gate, down
SERVE_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096),
                (3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336),
                (14336, 3584)]


def t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


@pytest.mark.parametrize("M", [1, 64, 512])
@pytest.mark.parametrize("K,N", SERVE_SHAPES)
def test_plan_on_serve_shapes(K, N, M):
    for w4, G, clusters in itertools.product(
            (False, True), (1, K // 128), (H100_CLUSTERS, None)):
        p = plan_a16(M, N, K, w4, G, SMS, clusters)
        rows = K // 2 if w4 else K
        assert p.stage_rows == (32 if w4 else 64)
        assert 1 <= p.splits <= MAX_SPLITS == 8
        assert len(p.bounds) == p.splits
        # the splits cover [0, rows) in order, none empty, none
        # overlapping, each starting on a stage
        assert p.bounds[0][0] == 0 and p.bounds[-1][1] == rows
        for (a, b), (c, _) in zip(p.bounds, p.bounds[1:]):
            assert b == c
        assert all(a < b and a % p.stage_rows == 0 for a, b in p.bounds)
        sizes = [-(-(b - a) // p.stage_rows) for a, b in p.bounds]
        assert max(sizes) - min(sizes) <= 1
        tiles = -(-M // p.bm) * -(-N // p.bn)
        assert p.blocks == tiles * p.splits
        slots = (clusters or [2 * SMS // s for s in range(1, 9)])
        assert p.splits == 1 or tiles <= slots[p.splits - 1]
        if tiles >= 2 * SMS:
            assert p.splits == 1
        stages = -(-rows // p.stage_rows)
        if tiles * min(MAX_SPLITS, stages) >= SMS:
            assert p.blocks >= SMS


def test_plan_examples():
    """The plans named in csrc/w8a16.cu's note, at M = 64 on the H100: the
    largest split whose clusters all fit at once."""
    def tiles_splits(K, N):
        p = plan_a16(64, N, K, False, 1, SMS, H100_CLUSTERS)
        return -(-N // p.bn), p.splits

    assert tiles_splits(4096, 4096) == (32, 7)      # 8 would need 32 > 30
    assert tiles_splits(4096, 11008) == (86, 2)
    assert tiles_splits(11008, 4096) == (32, 7)
    assert tiles_splits(3584, 2048) == (16, 8)
    assert tiles_splits(3584, 14336) == (112, 2)
    assert tiles_splits(14336, 3584) == (28, 8)
    p = plan_a16(64, 4096, 11008, False, 1, SMS, H100_CLUSTERS)
    assert sorted({(b - a) // 64 for a, b in p.bounds}) == [24, 25]
    # prefill: 688 tiles fill the card alone
    assert plan_a16(512, 11008, 4096, False, 1, SMS,
                    H100_CLUSTERS).splits == 1


def split_k_emulated(x, w, ws, xo=None, wo=None, fuse="none",
                     out_dtype=torch.float32, sm_count=8):
    """Kernel B's recipe with plan_a16's splits: per-split f32 partials
    (a W4 split of packed rows [a, b) covers K-rows [a, b) and
    [K/2 + a, K/2 + b)), summed in split order, then the outlier term, the
    epilogue and the cast. Returns the result and the plan."""
    M, K = x.shape
    w4 = w.dtype == torch.uint8
    G = ws.shape[0] if ws.dim() == 2 else 1
    plan = plan_a16(M, w.shape[1], K, w4, G, sm_count)
    wd = dequant_weight(w, ws).float()
    xf = x.float()
    y = None
    for a, b in plan.bounds:
        ks = torch.arange(a, b)
        if w4:
            ks = torch.cat([ks, ks + K // 2])
        part = xf[:, ks] @ wd[ks]
        y = part if y is None else y + part
    if xo is not None:
        y = y + xo.float() @ wo.float()
    return _build.apply_epilogue(y, fuse).to(out_dtype), plan


def _operands(M, K, N, G, B, w4, seed):
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.normal(0, 1, (M, K)), jnp.bfloat16))
    q_w = (rng.integers(-8, 8, (K, N)) if w4
           else rng.integers(-127, 128, (K, N))).astype(np.int8)
    ws = rng.uniform(0.01, 0.1, (G, N) if G else (N,)).astype(np.float32)
    w = np.asarray(JQ.pack_int4(jnp.asarray(q_w))) if w4 else q_w
    xo = wo = None
    if B:
        xo = np.asarray(jnp.asarray(rng.normal(0, 1, (M, B)), jnp.bfloat16))
        wo = np.asarray(jnp.asarray(rng.normal(0, 1, (B, N)), jnp.bfloat16))
    return x, w, ws, xo, wo


def _scale_of_terms(x, w, ws, xo=None, wo=None):
    """S = |x| @ |wd| (+ |x_out| @ |w_out|), in float64."""
    wd = dequant_weight(t(w), t(ws)).double().abs().numpy()
    S = np.abs(np.asarray(x, np.float32)).astype(np.float64) @ wd
    if xo is not None:
        S = S + (np.abs(np.asarray(xo, np.float32)).astype(np.float64)
                 @ np.abs(np.asarray(wo, np.float32)).astype(np.float64))
    return S


def _assert_close(got, ref, S):
    np.testing.assert_array_less(np.abs(np.asarray(got) - np.asarray(ref)),
                                 RTOL_S * S + 1e-30)


@pytest.mark.parametrize("w4,G,B,fuse", [
    (False, 0, 0, "none"), (True, 0, 0, "none"),
    (False, 8, 16, "silu"), (True, 8, 16, "silu")])
def test_split_k_recipe_vs_plain_and_pallas(w4, G, B, fuse):
    """At 8 SMs the 3 tiles of N = 384 split K: 4 ways at W8's K = 256 (4
    stages) and 5 ways, unevenly, at W4's (packed rows in 8 stages)."""
    K = 512 if w4 else 256
    ops = _operands(16, K, 384, G, B, w4, 21 + G + w4)
    got, plan = split_k_emulated(*[None if a is None else t(a) for a in ops],
                                 fuse=fuse)
    assert plan.splits == (5 if w4 else 4)
    S = _scale_of_terms(*ops)
    plain = w8a16_plain(*[None if a is None else t(a) for a in ops],
                        fuse=fuse, out_dtype=torch.float32)
    _assert_close(got.numpy(), plain.numpy(), S)
    j = j_mix_gemm(jnp.asarray(ops[0]), jnp.asarray(ops[1]), None,
                   *[None if a is None else jnp.asarray(a) for a in ops[2:]],
                   fuse=fuse, out_dtype=jnp.float32, interpret=True)
    _assert_close(got.numpy(), j, S)
    # the bf16 cast of the same sum
    gb, _ = split_k_emulated(*[None if a is None else t(a) for a in ops],
                             fuse=fuse, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(gb.float().numpy(),
                                  got.to(torch.bfloat16).float().numpy())


def test_split_k_recipe_vs_pallas_w8a16_matmul():
    """The w8a16_matmul contract (int8, per-channel, no epilogue) with K =
    704 (11 stages) split 6 ways: 2, 2, 2, 2, 2, 1 stages."""
    rng = np.random.default_rng(4)
    M, K, N = 9, 704, 256
    x = np.asarray(jnp.asarray(rng.normal(0, 1, (M, K)), jnp.bfloat16))
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    qw, ws = (np.asarray(a) for a in JQ.quantize_weight_int8(jnp.asarray(w)))
    got, plan = split_k_emulated(t(x), t(qw), t(ws), sm_count=6)
    assert plan.splits == 6
    assert [(b - a) // 64 for a, b in plan.bounds] == [2, 2, 2, 2, 2, 1]
    j = j_w8a16_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(ws),
                       out_dtype=jnp.float32, interpret=True)
    _assert_close(got.numpy(), j, _scale_of_terms(x, qw, ws))
