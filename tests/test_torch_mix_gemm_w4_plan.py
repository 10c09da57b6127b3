"""PyTorch port, kernel A's launch plans and split-K recipe on the CPU (the
mix_gemm kernel in its packed-W4, W4 grouped and W8 grouped modes).

`kernels/mix_gemm.py::plan_mix` on every linear shape the served W4A4 paths
give kernel A (Llama-2-7B q/k/v and up/gate in W4, per-channel and with
128-row groups; o/down in W8 with 128-row groups; Gemma-2-9B q, k/v and
up/gate in W4) at M = 1, 64 and 512, on 132 SMs with the H100's cluster
occupancy and with the default one: at most 8 splits, every cluster on the
card at once, splits that cover the stored rows exactly (a W4 split is
packed rows [a, b), which hold K-rows [a, b) and [K/2 + a, K/2 + b), so it
covers both halves), and on every grouped plan each split bound is a group
boundary.

The kernel's arithmetic with a plan's splits, emulated in PyTorch
(`emulated`): per-channel, each split's int32 partial over both halves of
its packed rows, the partials summed exactly, converted once and scaled in
JAX's order; grouped, each warp quad's run of 16-row steps, its int32 sum
folded into f32 (times the group's scale) whenever its next step lies in
another group, the two quads' f32 tiles added, then the splits' f32
partials in rank order, times x_scale. Per-channel W4 is bit-equal to the
unsplit sum (`mix_gemm_plain`) and to the Pallas mix_gemm (interpret=True)
at several forced splits; grouped stays within G f32 ulps of S = x_scale *
sum_g |float(acc_g) * w_scale[g]| of the Pallas kernel (the limit of
tests/test_torch_w4_gemm.py and of the card tests; the f32 group sum runs
in another order) at group sizes 32 and 128, with and without outlier
channels, at every epilogue (plus 1e-5 |y| + 1e-5, that file's limit for
the outlier dot's summation order and jax.nn's activations).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.pallas.mix_gemm import mix_gemm as j_mix_gemm
from mixq_tpu_torch.convert import tensor_from_numpy
from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.kernels.mix_gemm import KSTEP, mix_gemm_plain, plan_mix
from mixq_tpu_torch.ops.quant import unpack_int4

SMS = 132
# cudaOccupancyMaxActiveClusters of kernel 2's blocks (one per SM) for
# clusters of 1..8 blocks on an NVIDIA H100 80GB HBM3; kernel A's
# instantiations also hold one block per SM
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
# (K, N, w4, G) of every linear kernel A serves at group size 128 or
# per-channel: Llama-2-7B q/k/v, up/gate (W4, and W4 g128), o, down (W8
# g128); Gemma-2-9B q, k/v, up/gate (W4)
SERVE = ([(K, N, True, G) for K, N in ((4096, 4096), (4096, 11008))
          for G in (1, 32)]
         + [(4096, 4096, False, 32), (11008, 4096, False, 86)]
         + [(3584, N, True, 1) for N in (4096, 2048, 14336)])
FUSES = ["none", "silu", "gelu", "gelu_new"]


def t(a):
    return None if a is None else tensor_from_numpy(np.asarray(a), "cpu")


def forced(M, N, K, w4, G, S):
    """plan_mix with S splits: a cluster table on which S is the largest
    split that fits."""
    tiles = -(-M // 64) * -(-N // 128)
    return plan_mix(M, N, K, w4, G, SMS, (tiles,) * S + (0,) * (8 - S))


@pytest.mark.parametrize("M", [1, 64, 512])
def test_plans_on_serve_shapes(M):
    for K, N, w4, G in SERVE:
        rows = K // 2 if w4 else K
        gs = K // G
        for clusters in (H100_CLUSTERS, None):
            p = plan_mix(M, N, K, w4, G, SMS, clusters)
            assert p.stage_rows == KSTEP and (p.bm, p.bn) == (64, 128)
            assert 1 <= p.splits <= 8 and len(p.bounds) == p.splits
            # the stored rows [0, rows) in order, none empty: for W4 the
            # packed rows, each split holding both halves of its rows
            assert p.bounds[0][0] == 0 and p.bounds[-1][1] == rows
            assert all(b == c for (_, b), (c, _) in zip(p.bounds,
                                                        p.bounds[1:]))
            assert all(a < b and a % KSTEP == 0 for a, b in p.bounds)
            if G > 1:                     # split bounds on group boundaries
                assert all(a % gs == 0 and b % gs == 0 for a, b in p.bounds)
            tiles = -(-M // 64) * -(-N // 128)
            assert p.blocks == tiles * p.splits
            slots = clusters or [SMS // s for s in range(1, 9)]
            assert p.splits == 1 or tiles <= slots[p.splits - 1]
            if tiles > slots[1]:
                assert p.splits == 1


def test_plan_examples():
    """At M = 64 on the H100 (N-tiles x S): the W4 block of five and g128's
    o/down; the uneven splits of a unit that spans stages."""
    def plan(K, N, w4, G):
        p = plan_mix(64, N, K, w4, G, SMS, H100_CLUSTERS)
        return -(-N // p.bn), p.splits, [b - a for a, b in p.bounds]

    assert plan(4096, 4096, True, 1) == (32, 3, [768, 640, 640])
    assert plan(4096, 11008, True, 1) == (86, 1, [2048])
    assert plan(4096, 11008, True, 32) == (86, 1, [2048])
    assert plan(3584, 2048, True, 1) == (16, 6, [384, 384, 256, 256, 256,
                                                 256])
    assert plan(11008, 4096, False, 86) == (32, 3, [3712, 3712, 3584])
    # group 48 (16 x 3): units of lcm(128, 48) = 384 rows, a K tail of 16
    p = forced(9, 256, 1056, False, 22, 3)
    assert [b - a for a, b in p.bounds] == [384, 384, 288]
    # W4, group 160 of K/2 = 640 packed rows: units of 640, one split
    assert forced(9, 256, 1280, True, 8, 4).splits == 1


def emulated(q_x, w, xs, ws, xo=None, wo=None, fuse="none",
             out_dtype=torch.float32, splits=1):
    """The kernel's recipe with `splits` splits (see the module's doc)."""
    M, K = q_x.shape
    N = w.shape[1]
    w4 = w.dtype == torch.uint8
    wv = (unpack_int4(w) if w4 else w).long()
    x = q_x.long()
    G = ws.shape[0] if ws.dim() == 2 else 1
    rows = K // 2 if w4 else K
    plan = forced(M, N, K, w4, G, splits)
    assert plan.splits == splits
    if G == 1:
        acc = torch.zeros(M, N, dtype=torch.long)
        for a, b in plan.bounds:
            part = x[:, a:b] @ wv[a:b]
            if w4:                        # the packed rows' high halves
                part = part + x[:, rows + a:rows + b] @ wv[rows + a:rows + b]
            assert part.abs().max() < 2 ** 31
            acc = acc + part
        y = (acc.to(torch.int32).float() * xs.reshape(-1, 1)
             * ws.reshape(1, -1))
    else:
        gs = K // G
        y = torch.zeros(M, N)
        for a, b in plan.bounds:          # rank order
            quads = []
            for quad in (0, 1):
                # the quad's 16-row steps (K-rows) in the order it runs them
                if w4:
                    steps = [quad * rows + r for r in range(a, b, 16)]
                else:
                    steps = [r for s in range(a, b, KSTEP)
                             for r in range(s + 64 * quad,
                                            min(s + 64 * quad + 64, b), 16)]
                f = torch.zeros(M, N)
                acc = None
                for i, r in enumerate(steps):
                    part = x[:, r:r + 16] @ wv[r:r + 16]
                    acc = part if acc is None else acc + part
                    if i + 1 == len(steps) or steps[i + 1] // gs != r // gs:
                        f = f + acc.float() * ws[r // gs]
                        acc = None
                quads.append(f)
            y = y + (quads[0] + quads[1])
        y = y * xs.reshape(-1, 1)
    if xo is not None:
        y = y + torch.matmul(xo.float(), wo.float())
    return _build.apply_epilogue(y, fuse).to(out_dtype)


def _operands(M, K, N, G, B, w4, seed):
    rng = np.random.default_rng(seed)
    q_x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    q_w = (rng.integers(-8, 8, (K, N)) if w4
           else rng.integers(-127, 128, (K, N))).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (G, N) if G > 1 else (N,)).astype(np.float32)
    xo = wo = None
    if B:
        xo = np.asarray(jnp.asarray(rng.normal(0, 1, (M, B)), jnp.bfloat16))
        wo = np.asarray(jnp.asarray(rng.normal(0, 1, (B, N)), jnp.bfloat16))
    w = np.asarray(JQ.pack_int4(jnp.asarray(q_w))) if w4 else q_w
    return q_x, w, xs, ws, xo, wo


def _pallas(ops, fuse="none"):
    return np.asarray(j_mix_gemm(
        *[None if a is None else jnp.asarray(a) for a in ops], fuse=fuse,
        out_dtype=jnp.float32, interpret=True))


def _bits(y):
    return np.asarray(y).view(np.uint32)


@pytest.mark.parametrize("K,splits", [(512, 1), (1088, 2), (1088, 3),
                                      (1088, 5), (544, 3)])
def test_w4_split_recipe_bit_equal(K, splits):
    """Per-channel W4, no outliers: the same bits at every split (K = 1088:
    544 packed rows, 4 stages and a 32-row tail over 2, 3 or 5 splits;
    544: 2 stages and a tail over 3), as mix_gemm_plain and the Pallas
    mix_gemm."""
    ops = _operands(9, K, 256, 1, 0, True, K + splits)
    got = emulated(*[t(a) for a in ops], splits=splits)
    plain = mix_gemm_plain(*[t(a) for a in ops], out_dtype=torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(plain))
    np.testing.assert_array_equal(_bits(got), _bits(_pallas(ops)))


def _group_sum_atol(ops):
    """G f32 ulps (2**-23) of x_scale * sum_g |float(acc_g) * w_scale[g]|."""
    q_x, w, xs, ws = ops[:4]
    wv = np.asarray(unpack_int4(t(w))) if w.dtype == np.uint8 else w
    G, (M, K) = ws.shape[0], q_x.shape
    acc = np.einsum("mgk,gkn->gmn", q_x.reshape(M, G, K // G).astype(
        np.float64), wv.reshape(G, K // G, -1).astype(np.float64))
    return G * 2.0 ** -23 * np.abs(acc * ws[:, None, :]).sum(0) * xs


@pytest.mark.parametrize("fuse", FUSES)
@pytest.mark.parametrize("w4,K,G", [(True, 1024, 32), (True, 1024, 8),
                                    (False, 768, 24), (False, 768, 6)])
def test_grouped_split_recipe(w4, K, G, fuse):
    """Grouped, group sizes 32 and 128 (W4: K/2 = 512 packed rows, 4
    stages; W8: 768 rows, 6 stages), with and without 32 outlier channels:
    within the G-ulp limit of the Pallas kernel at S = 1, 2 and 3 (uneven
    splits of whole groups)."""
    for B in (0, 32):
        ops = _operands(17, K, 256, G, B, w4, K + G + B + len(fuse))
        ref = _pallas(ops, fuse)
        lim = _group_sum_atol(ops) + 1e-5 * np.abs(ref) + 1e-5
        for S in (1, 2, 3):
            got = emulated(*[t(a) for a in ops], fuse=fuse, splits=S)
            np.testing.assert_array_less(np.abs(got.numpy() - ref), lim)


def test_grouped_fold_inside_a_step():
    """A group of 48 rows ends inside a k32 step (16 rows into it), and
    units of lcm(128, 48) = 384 rows put the split bounds on groups: within
    the G-ulp limit of the Pallas kernel at S = 1 and 3."""
    ops = _operands(5, 1056, 128, 22, 16, False, 48)
    ref = _pallas(ops, "silu")
    lim = _group_sum_atol(ops) + 1e-5 * np.abs(ref) + 1e-5
    for S in (1, 3):
        got = emulated(*[t(a) for a in ops], fuse="silu", splits=S)
        np.testing.assert_array_less(np.abs(got.numpy() - ref), lim)


def test_w4_group_across_the_halves():
    """W4 with groups of 64 over K = 704 (the tiny gate's down projection
    under mix4_full_g64: 352 packed rows, 11 groups): 64 does not divide
    K/2, so group 5 (K-rows 320-383) lies in both halves, its low part
    folded by quad 0 and its high part by quad 1, and a split bound in the
    low half falls inside a high group. Within the G-ulp limit of the
    Pallas kernel at S = 1, 2 and 3, with and without outlier channels."""
    for B in (0, 32):
        ops = _operands(9, 704, 256, 11, B, True, 704 + B)
        ref = _pallas(ops, "none")
        lim = _group_sum_atol(ops) + 1e-5 * np.abs(ref) + 1e-5
        for S in (1, 2, 3):
            got = emulated(*[t(a) for a in ops], splits=S)
            np.testing.assert_array_less(np.abs(got.numpy() - ref), lim)
