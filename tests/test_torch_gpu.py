"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version at small shapes (edges, outliers, GQA, ragged lengths; kernel 1 at
decode and prefill rows, Llama's and Gemma-2's widths, a width that is not
a multiple of 8 and widths past its register kernel, in each of its
instantiations, its q_x, x_scale and x_out bit-equal to the plain quantizer
and gather fed its own y; the quantizers on the card bit-equal to the CPU's;
the int8
GEMM in its W8, packed-W4 and grouped modes, kernel 2 and W4 per-channel
bit-equal across their split-K plans, grouped deterministic at each; its
QUIK zero-point modes (W8 and packed W4) on asymmetric activations that
reach -128 / -8 and rows of zeros, with 256 outlier channels, bit-equal to
the plain version without an outlier term or epilogue and across split
plans, and a tiny QUIK model's logits on the card against the CPU; the
a16 GEMM with int8 and packed weights, per-channel and grouped scales and
outliers; every GEMM epilogue: SiLU, exact GELU and tanh GELU; flash
decode with gemma2's softcap and score scale, up to its 4096-slot window,
and on a peaked softmax; decode attention over the batch-major cache with
bf16 and int8 KV, GQA, per-row lengths and starts, rows with no valid
position, a ring read past its wrap, gemma2's softcap and scale, and a
peaked softmax; flash decode and decode attention split over clusters of
1, 2, 4 and 8 blocks, bit-equal across two launches of a plan, and flash
decode's peaked Gemma-2-9B case over 8 seeds against the plain version on
the card and on the CPU; both with ALiBi at every cluster size, kernel 3
with its rows held in probability levels, since ALiBi rows are peaked)
and the wrappers' refusals; W4A4O16 g128 (kernel A), QUIK W4A4 (the
zero-point modes) and W8A16 (kernel B) checkpoints saved from the card and loaded back onto it (the greedy
tokens of the params before the save; the CPU's load bit-equal), and the
safetensors reader copying a tensor onto the card in its stored dtype.
The tiny models served on the card against the same models on the CPU
are phase 4 of chip_smoke.py.

Every test here needs a CUDA card: the `cuda` fixture decides at run time
and skips with a reason elsewhere. This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:
    python -m pytest --noconftest -q tests/test_torch_gpu.py
(`--noconftest` because tests/conftest.py imports JAX).

Tolerances: y of kernel 1 within one bf16 ulp (2**-7 relative; the row's
sum of squares is added in another order), q_x within 1 LSB (and exact from
the kernel's own y); kernel 2 f32
outputs within 1e-4 (the outlier dot accumulates on tensor cores), bf16
outputs within one ulp; in the W4 and grouped modes f32 within 1e-4 |y| +
1e-4 plus G f32 ulps of S = x_scale * sum_g |float(acc_g) * w_scale[g]|
(the f32 group sum runs in another order and its terms can cancel), bf16
within one ulp more; the a16 kernel f32 within 1e-5 *
(|x| @ |wd|) (same bf16 operands, exact products, tensor-core summation
order), bf16 within one ulp; kernel 3 within two bf16 ulps of |y| plus
FLASH_ATOL, for a probability whose rounding (to int8, or to bf16 in bf16
mode) an exp() ulp flips; a typical |y| is ~0.1 here, and
tests/test_torch_flash_decode.py shows that the int8 limit stops a kernel
that skips the probability quantization; kernel 8 within two bf16 ulps of
|y| plus DECODE_ATOL (f32 throughout on both sides, summed in another
order: no probability is rounded, so a peaked softmax needs no wider
limit). The GELU epilogues call CUDA's
erfcf / tanhf in the kernel and torch's erfc / tanh in the plain version,
a few f32 ulps apart: inside every limit above."""
import pytest
import torch

from mixq_tpu_torch.kernels import _build
from mixq_tpu_torch.kernels.decode_attention import (DECODE_ATOL,
                                                     decode_attention,
                                                     decode_attention_plain)
from mixq_tpu_torch.kernels.flash_decode import (flash_decode_attention,
                                                 flash_decode_level,
                                                 flash_decode_plain)
from mixq_tpu_torch.kernels.mix_gemm import _clusters as _clusters_mix
from mixq_tpu_torch.kernels.mix_gemm import (_mix_gemm, int8_matmul_dequant,
                                             mix_gemm, mix_gemm_plain,
                                             plan_mix)
from mixq_tpu_torch.kernels.rmsnorm_quant import (INSTANTIATIONS, _rmsnorm,
                                                  fused_rmsnorm_quant,
                                                  quantize_normed,
                                                  rmsnorm_quant_plain)
from mixq_tpu_torch.kernels.w8a16 import (_clusters, dequant_weight,
                                          mix_gemm_a16, plan_a16,
                                          w8a16_matmul, w8a16_plain)
from mixq_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.gpu
BF16_ULP = 2.0 ** -7
FLASH_ATOL = {True: 8e-3, False: 5e-4}           # int8, bf16 KV
PEAK_LEVELS = {True: 3.0, False: 1.0}   # peaked softmax, levels of a row
FUSES = ["none", "silu", "gelu", "gelu_new"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def _rmsnorm_case(cuda, M, H, n_out, a_bits, offset=0):
    """Inputs of kernel 1 (x starts `offset` elements into its buffer)."""
    g = _gen(M + H)
    x = (torch.randn(M * H + offset, generator=g, device=cuda) * 3).to(
        torch.bfloat16)[offset:].view(M, H)
    gamma = 1 + 0.1 * torch.randn(H, generator=g, device=cuda)
    oset = None
    if n_out:
        idx = torch.randperm(H, generator=g, device=cuda)[:n_out]
        oset = Q.outlier_set_from_indices(idx, H, n_out, device=cuda)
    return (x, gamma, None if oset is None else oset.k_mask, 1e-5, a_bits,
            None if oset is None else oset.ind,
            None if oset is None else oset.mask)


def _assert_rmsnorm(args, got):
    """Kernel 1's outputs against the plain version (y within one bf16 ulp,
    q_x within 1 LSB, x_scale rtol 1e-5, x_out within one ulp) and, exactly,
    against the plain quantizer and gather fed the kernel's own y; both
    on the card and on a CPU copy of the inputs, so the card's plain
    version is not the only reference."""
    a_bits, ind = args[4], args[5]
    q = got[1]
    assert q.abs().max() <= 2 ** (a_bits - 1) - 1
    if ind is not None:
        assert (q[:, ind.long()] == 0).all()
    cpu = tuple(t.cpu() if torch.is_tensor(t) else t for t in args)
    for where, a in (("card", args), ("cpu", cpu)):
        d = a[0].device
        yk, qk, sk, xok = (None if t is None else t.to(d) for t in got)
        yp, qp, sp, xop = rmsnorm_quant_plain(*a)
        assert (yk.float() - yp.float()).abs().le(
            BF16_ULP * yp.float().abs()).all(), where
        assert (qk.int() - qp.int()).abs().max() <= 1, where
        torch.testing.assert_close(sk, sp, rtol=1e-5, atol=0)
        own = quantize_normed(yk, a[2], a_bits, a[5], a[6])
        assert torch.equal(qk, own[0]) and torch.equal(sk, own[1]), where
        if ind is not None:
            assert (xok.float() - xop.float()).abs().le(
                BF16_ULP * xop.float().abs()).all(), where
            assert torch.equal(xok, own[2]), where


@pytest.mark.parametrize("a_bits", [8, 4])
@pytest.mark.parametrize("M,H,n_out", [
    (1, 64, 0), (7, 4096, 128), (64, 4096, 0), (5, 11008, 16),
    # prefill rows; Gemma-2's width (ragged last chunks); a width that is
    # not a multiple of 8; widths past the register kernel, the second
    # past 48 KB of shared memory
    (512, 4096, 128), (8, 3584, 128), (3, 1003, 8), (2, 16384, 128),
    (2, 28672, 16)])
def test_rmsnorm_quant(cuda, M, H, n_out, a_bits):
    args = _rmsnorm_case(cuda, M, H, n_out, a_bits)
    before = fused_rmsnorm_quant.launches
    got = fused_rmsnorm_quant(*args)
    torch.cuda.synchronize()
    assert fused_rmsnorm_quant.launches == before + 1
    _assert_rmsnorm(args, got)


@pytest.mark.parametrize("M,H", [(64, 4096), (9, 3584), (512, 4096)])
def test_rmsnorm_quant_plans(cuda, M, H):
    """Every instantiation on the same rows (512 threads of one chunk, the
    looping kernel), each held as test_rmsnorm_quant holds it; an x off
    16-byte alignment takes the looping kernel, and the register kernel
    refuses it."""
    args = _rmsnorm_case(cuda, M, H, 128, 8)
    for plan in INSTANTIATIONS:
        _assert_rmsnorm(args, _rmsnorm(*args, plan=plan))
    odd = _rmsnorm_case(cuda, M, H, 128, 8, offset=1)
    assert odd[0].data_ptr() % 16
    _assert_rmsnorm(odd, fused_rmsnorm_quant(*odd))
    for plan in (p for p in INSTANTIATIONS if p[1]):
        with pytest.raises(RuntimeError):
            _rmsnorm(*odd, plan=plan)


def test_quantizers_divide_as_the_cpu(cuda, record_property):
    """quantize_act_per_token (A8 and A4), quantize_kv and prepare_act on
    the card give the bits they give on a CPU copy of the same inputs: each
    divides through true_div, where PyTorch on CUDA would run a division by
    a Python number as a multiply by the reciprocal. How many rows that
    multiply would have moved is recorded (`rows_off_by_reciprocal`), not
    held."""
    from mixq_tpu_torch.ops.mixed_linear import (LinearSpec, MixLinearParams,
                                                 prepare_act)

    g = _gen(11)
    x = (torch.randn(2048, 4096, generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    off = 0
    for bits in (8, 4):
        q, s = Q.quantize_act_per_token(x, bits)
        qc, sc = Q.quantize_act_per_token(x.cpu(), bits)
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
        qmax = 2 ** (bits - 1) - 1
        absmax = x.float().abs().amax(-1, keepdim=True)
        s_mul = torch.clamp_min(absmax * (1.0 / qmax), 1e-8)
        off += int((s_mul != s).sum())
    kv = torch.randn(64, 512, 8, 128, generator=g, device=cuda).to(
        torch.bfloat16)
    q, s = Q.quantize_kv(kv)
    qc, sc = Q.quantize_kv(kv.cpu())
    assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    s_mul = torch.clamp_min(kv.float().abs().amax(-1) * (1.0 / 127.0), 1e-8)
    off += int((s_mul != s).sum())
    H = 11008
    oset = Q.outlier_set_from_indices(
        torch.randperm(H, generator=g, device=cuda)[:128], H, 128,
        device=cuda)
    xd = (torch.randn(256, H, generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    cpu_oset = Q.OutlierSet(*(t.cpu() for t in oset))

    def act_of(xx, o, spec):
        p = MixLinearParams(
            q_weight=torch.zeros((H, 8), dtype=torch.int8, device=xx.device),
            w_scale=torch.ones(8, device=xx.device), out_ind=o.ind,
            out_mask=o.mask, k_mask=o.k_mask, out_count=o.count)
        return prepare_act(xx, p, spec)

    for spec in (LinearSpec(), LinearSpec(w_bit=4, a_bit=4)):
        card = act_of(xd, oset, spec)
        for a, b in zip(card, act_of(xd.cpu(), cpu_oset, spec)):
            assert torch.equal(a.cpu(), b)
    record_property("rows_off_by_reciprocal", off)
    print(f"a multiply by the reciprocal would move {off} scales of "
          f"{2 * 2048 + 64 * 512 * 8} rows")


@pytest.mark.parametrize("M,K,N,B", [
    (1, 256, 384, 0), (7, 512, 256, 0), (64, 256, 640, 32),
    (33, 384, 400, 16), (130, 4096, 4096, 128),
    # kernel 2's plans on the H100: M-tiles with 1, 2 and 17 live rows, N
    # not a multiple of 128, K tails inside a stage (272, 1040, 528), S = 8
    # over 86 stages at M = 1, S = 3 over K tails, S = 1 at Llama's up and
    # at M = 512, and an outlier budget past one 128-channel chunk (144)
    (17, 272, 400, 16), (65, 1040, 2064, 128), (1, 11008, 400, 128),
    (64, 4096, 11008, 128), (512, 4096, 2064, 0), (70, 528, 2064, 144)])
@pytest.mark.parametrize("fuse", FUSES)
def test_mix_gemm(cuda, M, K, N, B, fuse):
    g = _gen(M + K + N)
    q_x = torch.randint(-127, 128, (M, K), generator=g, device=cuda,
                        dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                      dtype=torch.int8)
    xs = torch.rand(M, 1, generator=g, device=cuda) * 1e-3 + 1e-4
    ws = torch.rand(N, generator=g, device=cuda) * 1e-3 + 1e-4
    xo = wo = None
    if B:
        xo = torch.randn(M, B, generator=g, device=cuda).to(torch.bfloat16)
        wo = torch.randn(B, N, generator=g, device=cuda).to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mix_gemm(q_x, w, xs, ws, xo, wo, fuse, out_dtype)
        torch.cuda.synchronize()
        ref = mix_gemm_plain(q_x, w, xs, ws, xo, wo, fuse, out_dtype)
        assert got.shape == (M, N) and got.dtype == out_dtype
        if out_dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
        else:
            err = (got.float() - ref.float()).abs()
            over = err - (BF16_ULP * ref.float().abs() + 1e-6)
            i = int(over.argmax())
            assert over.max() <= 0, (f"bf16 off by {err.flatten()[i]} at "
                                     f"y = {ref.flatten()[i]}")


@pytest.mark.parametrize("fuse", FUSES)
def test_w8a8_outlier_chunks(cuda, fuse):
    """256 outlier channels (N(0, 1) weights), which kernel 2 takes in two
    chunks of 128: f32 within test_mix_gemm's f32 limit, and the bf16
    output the kernel's own f32 result rounded once. Near y = 0 the f32
    outlier sum (|partial sums| ~16) differs from torch's by an f32 ulp of
    16, ~2e-6, so the bf16 output is held to its f32 value, not to
    test_mix_gemm's 1e-6."""
    M, K, N, B = 512, 1040, 400, 256
    ops = _w4_gemm_operands(cuda, _gen(M + K + N), M, K, N, 0, B, False)
    got = mix_gemm(*ops, fuse, torch.float32)
    got_bf16 = mix_gemm(*ops, fuse, torch.bfloat16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, mix_gemm_plain(*ops, fuse, torch.float32),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_w8a8_bit_equal_across_plans(cuda, out_dtype):
    """Kernel 2's split partials are int32 and add exactly, and the outlier
    term runs the same MMAs whatever the split: S = 1, 2, 5 and 8 (5: 86
    stages split unevenly) and two launches give the same bits, at
    11008x4096 with 128 outlier channels and SiLU."""
    ops = _w4_gemm_operands(cuda, _gen(11), 64, 11008, 4096, 0, 128, False)
    runs = [_mix_gemm(*ops, "silu", out_dtype, splits=S)
            for S in (1, 2, 5, 8, 8)]
    runs.append(mix_gemm(*ops, "silu", out_dtype))
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(runs[0].view(torch.uint8), r.view(torch.uint8))
    ref = mix_gemm_plain(*ops, "silu", out_dtype)
    assert (runs[0].float() - ref.float()).abs().le(
        BF16_ULP * ref.float().abs() + 1e-4).all()


@pytest.mark.parametrize("M,K,N", [(512, 4096, 11008), (64, 4096, 4096),
                                   (1, 3584, 2048)])
def test_w8a8_one_launch_per_call(cuda, M, K, N):
    """One launch per call, counted once as "w8a8" and once by epilogue,
    whatever the plan (S = 1 at prefill's 688 tiles, S > 1 at decode), the
    int8_matmul_dequant entry too; every split count fits the card as a
    cluster, and the plan's clusters all fit at once."""
    ops = _w4_gemm_operands(cuda, _gen(M), M, K, N, 0, 16, False)
    before = mix_gemm.launches
    modes = dict(mix_gemm.mode_launches)
    for i in range(3):
        mix_gemm(*ops, "gelu_new")
        assert mix_gemm.launches == before + i + 1
    int8_matmul_dequant(*ops[:4])
    assert mix_gemm.launches == before + 4
    assert mix_gemm.mode_launches["w8a8"] == modes["w8a8"] + 4
    assert mix_gemm.mode_launches["gelu_new"] == modes["gelu_new"] + 3
    clusters = _clusters_mix(0, False, False)
    assert all(n > 0 for n in clusters)
    p = plan_mix(M, N, K, False, 1, _build.sm_count(0), clusters)
    assert (p.splits == 1) == (M == 512)
    assert p.splits == 1 or -(-N // 128) <= clusters[p.splits - 1]


def test_int8_matmul_dequant_and_checks(cuda):
    g = _gen(5)
    q_x = torch.randint(-127, 128, (33, 128), generator=g, device=cuda,
                        dtype=torch.int8)
    w = torch.randint(-127, 128, (128, 96), generator=g, device=cuda,
                      dtype=torch.int8)
    xs, ws = torch.ones(33, 1, device=cuda), torch.ones(96, device=cuda)
    got = int8_matmul_dequant(q_x, w, xs, ws, out_dtype=torch.float32)
    ref = mix_gemm_plain(q_x, w, xs, ws, out_dtype=torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        mix_gemm(q_x, w, xs, ws, fuse="relu")
    with pytest.raises(ValueError):                # N % 16 != 0
        mix_gemm(q_x, w[:, :70].contiguous(), xs, ws[:70].contiguous())


def _w4_gemm_operands(cuda, g, M, K, N, G, B, w4):
    q_x = torch.randint(-127, 128, (M, K), generator=g, device=cuda,
                        dtype=torch.int8)
    lo, hi = (-8, 8) if w4 else (-127, 128)
    q_w = torch.randint(lo, hi, (K, N), generator=g, device=cuda,
                        dtype=torch.int8)
    xs = torch.rand(M, 1, generator=g, device=cuda) * 1e-3 + 1e-4
    ws = torch.rand(*((G, N) if G else (N,)), generator=g, device=cuda)
    ws = ws * 1e-3 + 1e-4
    xo = wo = None
    if B:
        xo = torch.randn(M, B, generator=g, device=cuda).to(torch.bfloat16)
        wo = torch.randn(B, N, generator=g, device=cuda).to(torch.bfloat16)
    return q_x, Q.pack_int4(q_w) if w4 else q_w, xs, ws, xo, wo


def _group_sum_atol(q_x, w, xs, ws):
    """G f32 ulps of x_scale * sum_g |float(acc_g) * w_scale[g]|."""
    if ws.dim() == 1:
        return 0.0
    wv = Q.unpack_int4(w) if w.dtype == torch.uint8 else w
    G, (M, K) = ws.shape[0], q_x.shape
    acc = torch.einsum("mgk,gkn->gmn", q_x.double().reshape(M, G, K // G),
                       wv.double().reshape(G, K // G, -1))
    S = (acc * ws[:, None, :].double()).abs().sum(0) * xs.double()
    return (G * 2.0 ** -23 * S).float()


@pytest.mark.parametrize("M,K,N,G,B,w4", [
    (1, 256, 384, 0, 0, True), (70, 512, 400, 0, 32, True),
    (64, 4096, 4096, 0, 128, True),
    (1, 256, 384, 8, 0, False), (33, 512, 256, 4, 16, False),
    (130, 11008, 4096, 86, 128, False),
    (16, 512, 384, 4, 0, True), (70, 256, 400, 8, 16, True),
    (64, 4096, 11008, 32, 128, True),
    # the tiny PPL gate's linears with 64-row groups (H = 256, I = 704):
    # q/k/v/o and up/gate in W4; down in W8 (mix4_g64) and in W4
    # (mix4_full_g64: 11 groups over 352 packed rows, 64 not dividing K/2)
    (1024, 256, 256, 4, 128, True), (1024, 256, 704, 4, 128, True),
    (1024, 704, 256, 11, 128, False), (1024, 704, 256, 11, 128, True),
    (70, 704, 256, 11, 0, True)])
@pytest.mark.parametrize("fuse", FUSES)
def test_mix_gemm_w4_and_grouped(cuda, M, K, N, G, B, w4, fuse):
    g = _gen(M + K + N + G)
    ops = _w4_gemm_operands(cuda, g, M, K, N, G, B, w4)
    mode = ("w4" if w4 else "w8a8") + ("_grouped" if G else "")
    before = mix_gemm.mode_launches[mode]
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mix_gemm(*ops, fuse, out_dtype)
        torch.cuda.synchronize()
        ref = mix_gemm_plain(*ops, fuse, out_dtype)
        assert got.shape == (M, N) and got.dtype == out_dtype
        # f32: the f32 limit; bf16: one ulp of |y| on top of it (near
        # y = 0, where the outlier term cancels, the f32 limit decides)
        tol = 1e-4 * ref.float().abs() + 1e-4 + _group_sum_atol(*ops[:4])
        if out_dtype == torch.bfloat16:
            tol = tol + BF16_ULP * ref.float().abs()
        assert (got.float() - ref.float()).abs().le(tol).all()
    assert mix_gemm.mode_launches[mode] == before + 2


def test_w4_bit_equal_across_plans(cuda):
    """W4 per-channel: the splits' int32 partials add exactly and the
    outlier term runs the same MMAs whatever the split, so S = 1, 2, the
    plan's S and 8 (uneven splits of 16 stages, each over both halves of
    its packed rows) and two launches give the same bits, at 4096x4096
    with A4 activations, 128 outlier channels and SiLU."""
    M, K, N = 64, 4096, 4096
    ops = _w4_gemm_operands(cuda, _gen(12), M, K, N, 0, 128, True)
    plan = plan_mix(M, N, K, True, 1, _build.sm_count(0),
                    _clusters_mix(0, True, False))
    assert plan.splits > 1
    for out_dtype in (torch.float32, torch.bfloat16):
        runs = [_mix_gemm(*ops, "silu", out_dtype, splits=S)
                for S in (1, 2, plan.splits, 8, 8)]
        runs.append(mix_gemm(*ops, "silu", out_dtype))
        torch.cuda.synchronize()
        for r in runs[1:]:
            assert torch.equal(runs[0].view(torch.uint8), r.view(torch.uint8))
        ref = mix_gemm_plain(*ops, "silu", out_dtype)
        assert (runs[0].float() - ref.float()).abs().le(
            BF16_ULP * ref.float().abs() + 1e-4).all()


@pytest.mark.parametrize("M,K,N,G,w4", [
    (64, 4096, 4096, 32, True), (64, 11008, 4096, 86, False),
    (17, 1536, 400, 48, True), (33, 1056, 256, 22, False),
    (33, 2048, 256, 4, False), (1, 16384, 128, 2, True),
    (1024, 704, 256, 11, True), (33, 704, 256, 11, False)])
def test_grouped_split_k(cuda, M, K, N, G, w4):
    """Grouped: the splits' f32 partials add in rank order, so two launches
    at one S are bit-equal, and at every S (1, 2, 3, the plan's, 8) the
    result is within the G-ulp limit of test_mix_gemm_w4_and_grouped of
    the plain version. Groups of 128 (the served o/down and W4 g128: one
    fold per stage), of 32 over W4 halves and of 48, which ends inside a
    k32 step and makes a split unit of 3 stages (a fold check per k-step),
    and of 512 (W8, a group over 4 stages) and 8192 (W4, a whole split:
    forced splits past the first are empty)."""
    ops = _w4_gemm_operands(cuda, _gen(M + K + G), M, K, N, G, 128, w4)
    plan = plan_mix(M, N, K, w4, G, _build.sm_count(0),
                    _clusters_mix(0, w4, True))
    for out_dtype in (torch.float32, torch.bfloat16):
        ref = mix_gemm_plain(*ops, "silu", out_dtype)
        tol = 1e-4 * ref.float().abs() + 1e-4 + _group_sum_atol(*ops[:4])
        if out_dtype == torch.bfloat16:
            tol = tol + BF16_ULP * ref.float().abs()
        for S in sorted({1, 2, 3, plan.splits, 8}):
            a, b = (_mix_gemm(*ops, "silu", out_dtype, splits=S) for _ in "ab")
            torch.cuda.synchronize()
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            assert (a.float() - ref.float()).abs().le(tol).all(), S


@pytest.mark.parametrize("w4,G", [(True, 1), (True, 32), (False, 32)])
def test_kernel_a_one_launch_per_call(cuda, w4, G):
    """One launch per call in each of kernel A's modes, counted once by
    weight mode and once by epilogue, at decode (S > 1) and prefill (S = 1)
    shapes; every split count of the mode fits the card as a cluster."""
    mode = ("w4" if w4 else "w8a8") + ("_grouped" if G > 1 else "")
    clusters = _clusters_mix(0, w4, G > 1)
    assert all(n > 0 for n in clusters)
    for M in (64, 512):
        ops = _w4_gemm_operands(cuda, _gen(M), M, 4096, 4096, G if G > 1
                                else 0, 16, w4)
        before = mix_gemm.launches
        modes = dict(mix_gemm.mode_launches)
        for i in range(3):
            mix_gemm(*ops, "gelu_new")
            assert mix_gemm.launches == before + i + 1
        assert mix_gemm.mode_launches[mode] == modes[mode] + 3
        assert mix_gemm.mode_launches["gelu_new"] == modes["gelu_new"] + 3
        p = plan_mix(M, 4096, 4096, w4, G, _build.sm_count(0), clusters)
        assert (p.splits == 1) == (M == 512)
        assert p.splits == 1 or 32 <= clusters[p.splits - 1]


def _zp_operands(cuda, g, M, K, N, B, w4):
    """QUIK operands: bf16 activations through the asymmetric quantizer (A4
    for packed W4, A8 for W8), row 0 all zeros (every channel an outlier)
    and row 1 with one large negative channel (q at -8 / -128); random
    int weights, their reduced_w, w_scale, and B outlier channels."""
    x = (torch.randn(M, K, generator=g, device=cuda) * 0.5)
    x[0] = 0.0
    if M > 1:
        x[1, 3] = -40.0
    q_x, xs, xz = Q.quantize_act_asymmetric(x.to(torch.bfloat16),
                                            bits=4 if w4 else 8)
    lo, hi = (-8, 8) if w4 else (-127, 128)
    q_w = torch.randint(lo, hi, (K, N), generator=g, device=cuda,
                        dtype=torch.int8)
    ws = torch.rand(N, generator=g, device=cuda) * 1e-2 + 1e-3
    xo = wo = None
    if B:
        xo = torch.randn(M, B, generator=g, device=cuda).to(torch.bfloat16)
        wo = (torch.randn(B, N, generator=g, device=cuda) * 0.05).to(
            torch.bfloat16)
    zp = dict(x_zero=xz, reduced_w=Q.reduced_weight_rowsum(q_w))
    return (q_x, Q.pack_int4(q_w) if w4 else q_w, xs, ws, xo, wo), zp


def _zp_close(got, ref):
    """f32 within 1e-4 |y| + 1e-4 (the outlier dot on tensor cores, the
    epilogue's expf); bf16 one ulp more."""
    tol = 1e-4 * ref.float().abs() + 1e-4
    if got.dtype == torch.bfloat16:
        tol = tol + BF16_ULP * ref.float().abs()
    err = (got.float() - ref.float()).abs()
    assert err.le(tol).all(), float((err - tol).max())


@pytest.mark.parametrize("M,K,N,B", [
    (1, 256, 384, 0), (8, 4096, 4096, 256), (64, 4096, 11008, 256),
    (33, 1056, 400, 16), (130, 512, 2064, 144), (64, 11008, 4096, 256)])
@pytest.mark.parametrize("w4", [True, False])
@pytest.mark.parametrize("fuse", ["none", "silu"])
def test_zero_point_gemm(cuda, M, K, N, B, w4, fuse):
    """QUIK's zero-point modes against the plain version (M-tiles of 1
    and 17 live rows, K tails inside a stage: 1056, N not a multiple of
    128, 256 outlier channels in two chunks); without an outlier term and
    epilogue the f32 result is the plain version's bits (the same f32
    steps, none contracted)."""
    ops, zp = _zp_operands(cuda, _gen(M + K + N + B), M, K, N, B, w4)
    q_x = ops[0]
    assert int(q_x.min()) == (-8 if w4 else -128)
    assert bool((q_x[0] == q_x.min()).all())         # the row of zeros
    mode = "w4_zp" if w4 else "w8a8_zp"
    before = mix_gemm.mode_launches[mode]
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mix_gemm(*ops, fuse, out_dtype, **zp)
        torch.cuda.synchronize()
        ref = mix_gemm_plain(*ops, fuse, out_dtype, **zp)
        assert got.shape == (M, N) and got.dtype == out_dtype
        assert bool(torch.isfinite(got).all())
        if not B and fuse == "none":
            assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
        else:
            _zp_close(got, ref)
    assert mix_gemm.mode_launches[mode] == before + 2


@pytest.mark.parametrize("w4,K,N", [(True, 4096, 4096), (True, 4096, 11008),
                                    (False, 11008, 4096)])
def test_zero_point_bit_equal_across_plans(cuda, w4, K, N):
    """The zero-point term is added once, to the sum of the splits' int32
    partials: S = 1..8, the plan's S and two launches give the same bits,
    with 256 outlier channels (two chunks of 128) and SiLU, at Llama-2-7B's
    shapes and M = 64 (and M = 8)."""
    for M in (64, 8):
        ops, zp = _zp_operands(cuda, _gen(M + K), M, K, N, 256, w4)
        plan = plan_mix(M, N, K, w4, 1, _build.sm_count(0),
                        _clusters_mix(0, w4, False, True))
        for out_dtype in (torch.float32, torch.bfloat16):
            runs = [_mix_gemm(*ops, "silu", out_dtype, splits=S, **zp)
                    for S in (1, 2, 3, 4, 5, 6, 7, 8, 8)]
            runs.append(mix_gemm(*ops, "silu", out_dtype, **zp))
            torch.cuda.synchronize()
            for r in runs[1:]:
                assert torch.equal(runs[0].view(torch.uint8),
                                   r.view(torch.uint8))
            _zp_close(runs[0], mix_gemm_plain(*ops, "silu", out_dtype, **zp))
        assert 1 <= plan.splits <= 8


@pytest.mark.parametrize("w4", [True, False])
def test_zero_point_one_launch_per_call(cuda, w4):
    """One launch per call, counted once by its zero-point mode and once
    by epilogue; every split count fits the card as a cluster; grouped
    scales or half a zero point raise, on the card too."""
    mode = "w4_zp" if w4 else "w8a8_zp"
    clusters = _clusters_mix(0, w4, False, True)
    assert all(n > 0 for n in clusters)
    ops, zp = _zp_operands(cuda, _gen(3), 64, 4096, 4096, 16, w4)
    before = mix_gemm.launches
    modes = dict(mix_gemm.mode_launches)
    for i in range(3):
        mix_gemm(*ops, "silu", **zp)
        assert mix_gemm.launches == before + i + 1
    assert mix_gemm.mode_launches[mode] == modes[mode] + 3
    assert mix_gemm.mode_launches["silu"] == modes["silu"] + 3
    assert mix_gemm.mode_launches["w4" if w4 else "w8a8"] == modes[
        "w4" if w4 else "w8a8"]
    with pytest.raises(ValueError):
        mix_gemm(*ops, x_zero=zp["x_zero"])
    grouped = torch.ones(32, 4096, device=cuda)
    with pytest.raises(ValueError):
        mix_gemm(ops[0], ops[1], ops[2], grouped, **zp)


def test_quik_model_on_the_card_equals_the_cpu(cuda, record_property):
    """A tiny QUIK W4A4 llama (o/down W8A8, 16 outlier channels on every
    linear input) on the card through the zero-point modes against the
    same params on the CPU (the plain versions), int8 KV on the head-major
    cache: one prefill's and three decode steps' logits within 1e-5 of
    max|logits| (chip_smoke.py's TINY_TOL for the tiny W4A4 llama), and the
    same greedy tokens."""
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig, QuantConfig
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.models.decoder import init_decoder_params
    from mixq_tpu_torch.quantize import resolve_specs

    cfg = _tiny_cfg("llama")
    # the head-major cache (kernel 3): kernel 8 sums in another order
    specs = dataclasses.replace(resolve_specs(QuantConfig.quik_w4a4(
        outlier_budget=16)), attn_impl="flash")
    params = init_decoder_params(cfg, specs, torch.Generator().manual_seed(
        4), device="cpu", dtype=torch.bfloat16, outlier_budget=16)
    ecfg = EngineConfig(max_seq_len=64, prefill_chunk=8, kv_dtype="int8")
    toks = torch.randint(1, cfg.vocab_size, (3, 8),
                         generator=torch.Generator().manual_seed(5))
    logits = {}
    for dev in ("cpu", cuda):
        eng = InferenceEngine(params_to(params, dev), cfg, specs, ecfg,
                              device=dev)
        cache = eng.new_cache(3, 64)
        reset_launch_counts()
        out, cache = eng.prefill(toks.to(dev), cache)
        steps = [out]
        for _ in range(3):
            tok = torch.argmax(steps[-1], -1).to(torch.int32)[:, None]
            out, cache = eng.decode_step(tok, cache)
            steps.append(out)
        logits[str(dev)] = torch.stack([s.float().cpu() for s in steps])
        if dev != "cpu":
            counts = launch_counts()
    cpu, card = logits["cpu"], logits[str(cuda)]
    rel = float((card - cpu).abs().max() / cpu.abs().max())
    record_property("max_rel_logits_gap", rel)
    L = cfg.num_hidden_layers
    assert counts["mix_gemm.w4_zp"] == 5 * L * 4
    assert counts["mix_gemm.w8a8_zp"] == 2 * L * 4
    assert counts["rmsnorm_quant"] == 0
    assert rel <= 1e-5, rel
    assert torch.equal(card.argmax(-1), cpu.argmax(-1))


def _a16_operands(cuda, g, M, K, N, G, B, w4):
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    lo, hi = (-8, 8) if w4 else (-127, 128)
    q_w = torch.randint(lo, hi, (K, N), generator=g, device=cuda,
                        dtype=torch.int8)
    ws = torch.rand(*((G, N) if G else (N,)), generator=g, device=cuda)
    ws = ws * 1e-2 + 1e-3
    xo = wo = None
    if B:
        xo = torch.randn(M, B, generator=g, device=cuda).to(torch.bfloat16)
        wo = (torch.randn(B, N, generator=g, device=cuda) * 0.02).to(
            torch.bfloat16)
    return x, Q.pack_int4(q_w) if w4 else q_w, ws, xo, wo


@pytest.mark.parametrize("M,K,N,G,B,w4", [
    (1, 256, 384, 0, 0, False), (70, 512, 400, 0, 0, False),
    (64, 4096, 11008, 0, 0, False), (1, 256, 384, 0, 0, True),
    (70, 512, 400, 0, 16, True), (33, 512, 256, 4, 0, False),
    (16, 256, 384, 8, 16, True), (64, 4096, 11008, 32, 0, True),
    # split K on the H100: 7 splits of 172 stages (uneven) at M = 1; 6 of
    # 224 over three M tiles, the last ragged; W8 groups of 48 rows inside a
    # stage; W4 groups of 128 straddling the 224-row splits; W4 groups of
    # 160 straddling the halves (K/2 = 720) and 23 stages over 8 splits
    (1, 11008, 4096, 0, 0, False), (130, 14336, 1536, 0, 0, False),
    (33, 1536, 256, 32, 16, False), (64, 3584, 256, 28, 0, True),
    (70, 1440, 400, 9, 16, True)])
@pytest.mark.parametrize("fuse", FUSES)
def test_a16_gemm(cuda, M, K, N, G, B, w4, fuse):
    g = _gen(M + K + N + G + 1)
    ops = _a16_operands(cuda, g, M, K, N, G, B, w4)
    x, w, ws, xo, wo = ops
    S = x.float().abs() @ dequant_weight(w, ws).float().abs()
    if B:
        S = S + xo.float().abs() @ wo.float().abs()
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mix_gemm_a16(*ops, fuse, out_dtype)
        torch.cuda.synchronize()
        ref = w8a16_plain(*ops, fuse, out_dtype)
        assert got.shape == (M, N) and got.dtype == out_dtype
        if out_dtype == torch.float32:
            assert (got - ref).abs().le(1e-5 * S).all()
        else:
            assert (got.float() - ref.float()).abs().le(
                BF16_ULP * ref.float().abs() + 1e-5 * S).all()
    # the mix_gemm wrapper hands a bf16 activation to this kernel
    before = mix_gemm_a16.launches
    got = mix_gemm(x, w, None, ws, xo, wo, fuse, torch.float32)
    assert mix_gemm_a16.launches == before + 1
    assert (got - w8a16_plain(*ops, fuse, torch.float32)).abs().le(
        1e-5 * S).all()


@pytest.mark.parametrize("M,K,N,G,w4", [(64, 11008, 4096, 0, False),
                                        (130, 14336, 2048, 0, False),
                                        (64, 3584, 256, 28, True)])
def test_a16_split_k_is_deterministic(cuda, M, K, N, G, w4):
    """The S partials are summed in rank order inside the cluster: two
    launches on the same inputs are bit-equal."""
    ops = _a16_operands(cuda, _gen(M + K), M, K, N, G, 16, w4)
    plan = plan_a16(M, N, K, w4, G or 1, _build.sm_count(0),
                    _clusters(0, w4, G > 1))
    assert plan.splits > 1
    for out_dtype in (torch.float32, torch.bfloat16):
        a = mix_gemm_a16(*ops, "silu", out_dtype)
        b = mix_gemm_a16(*ops, "silu", out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("M,K,N", [(512, 4096, 11008), (64, 4096, 4096),
                                   (1, 3584, 2048)])
def test_a16_one_launch_per_call(cuda, M, K, N):
    """One launch per call, whatever the plan (S = 1 at prefill's 688
    tiles, S > 1 at decode, every cluster of the plan on the card at
    once), and every split count fits the card as a cluster."""
    x, w, ws, _, _ = _a16_operands(cuda, _gen(M), M, K, N, 0, 0, False)
    before = mix_gemm_a16.launches
    modes = dict(mix_gemm_a16.mode_launches)
    for i in range(3):
        mix_gemm_a16(x, w, ws)
        assert mix_gemm_a16.launches == before + i + 1
    assert mix_gemm_a16.mode_launches["w8"] == modes["w8"] + 3
    for w4 in (False, True):
        for grouped in (False, True):
            clusters = _clusters(0, w4, grouped)
            assert all(n > 0 for n in clusters)
            p = plan_a16(M, N, K, w4, 1 + grouped, _build.sm_count(0),
                         clusters)
            assert (p.splits == 1) == (M == 512)
            assert p.splits == 1 or -(-N // 128) <= clusters[p.splits - 1]


def test_w8a16_matmul_entry(cuda):
    g = _gen(9)
    x, w, ws, _, _ = _a16_operands(cuda, g, 33, 4096, 4096, 0, 0, False)
    got = w8a16_matmul(x, w, ws, out_dtype=torch.float32)
    ref = w8a16_plain(x, w, ws, out_dtype=torch.float32)
    S = x.float().abs() @ dequant_weight(w, ws).float().abs()
    assert (got - ref).abs().le(1e-5 * S).all()
    with pytest.raises(ValueError):                 # packed: not its contract
        w8a16_matmul(x, Q.pack_int4(w.clamp(-8, 7)), ws)


def test_gemm_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = _gen(11)
    q_x, w4, xs, ws, _, _ = _w4_gemm_operands(cuda, g, 8, 80, 64, 0, 0, True)
    with pytest.raises(ValueError):                 # W4: K % 32 != 0
        mix_gemm(q_x, w4, xs, ws)
    q_x, w, xs, ws, _, _ = _w4_gemm_operands(cuda, g, 8, 256, 64, 8, 0, False)
    with pytest.raises(ValueError):                 # 5 groups: K % G != 0
        mix_gemm(q_x, w, xs, ws[:5].contiguous())
    q_x, w, xs, ws, _, _ = _w4_gemm_operands(cuda, g, 8, 384, 64, 3, 0, True)
    # W4 with a group (128) that does not divide K/2 = 192 is taken: the
    # group across the halves folds in two parts (test_grouped_split_k)
    ref = mix_gemm_plain(q_x, w, xs, ws, out_dtype=torch.float32)
    got = mix_gemm(q_x, w, xs, ws, out_dtype=torch.float32)
    assert (got - ref).abs().le(1e-4 * ref.abs() + 1e-4
                                + _group_sum_atol(q_x, w, xs, ws)).all()
    with pytest.raises(ValueError):                 # group_size 8 % 16 != 0
        mix_gemm(q_x, Q.unpack_int4(w), xs,
                 torch.ones(48, 64, device=cuda))
    x, w, ws, _, _ = _a16_operands(cuda, g, 8, 256, 64, 0, 0, False)
    with pytest.raises(ValueError):                 # a16: x must be bf16
        mix_gemm_a16(x.float(), w, ws)
    with pytest.raises(ValueError):                 # a16: N % 16 != 0
        mix_gemm_a16(x, w[:, :40].contiguous(), ws[:40].contiguous())
    with pytest.raises(NotImplementedError):
        mix_gemm_a16(x, w, ws, fuse="relu")


def _cache(cuda, g, L, nkv, B, S, D, int8, pad, k_offset=0.0):
    if int8:
        kf = torch.randn(L, nkv, B, S, D, generator=g, device=cuda) + k_offset
        vf = torch.randn(L, nkv, B, S, D, generator=g, device=cuda)
        k, ks = Q.quantize_kv(kf)
        v, vs = Q.quantize_kv(vf)
        if pad:
            Sp = -(-S // 128) * 128
            ks = torch.nn.functional.pad(ks, (0, Sp - S), value=1.0)
            vs = torch.nn.functional.pad(vs, (0, Sp - S), value=1.0)
        return k, v, ks.contiguous(), vs.contiguous()
    k = torch.randn(L, nkv, B, S, D, generator=g, device=cuda) + k_offset
    v = torch.randn(L, nkv, B, S, D, generator=g, device=cuda)
    return k.to(torch.bfloat16), v.to(torch.bfloat16), None, None


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D,S", [(4, 4, 64, 128), (8, 2, 128, 200),
                                        (32, 8, 128, 512), (2, 2, 32, 64)])
def test_flash_decode(cuda, int8, nq, nkv, D, S):
    g = _gen(nq + D + S)
    B, L = 5, 2
    q = torch.randn(B, nq, D, generator=g, device=cuda).to(torch.bfloat16)
    k, v, ks, vs = _cache(cuda, g, L, nkv, B, S, D, int8, pad=S % 128 != 0)
    lengths = torch.tensor([S, S // 2 + 1, 0, 9, 1], dtype=torch.int32,
                           device=cuda)
    start = torch.tensor([0, 5, 0, 3, 0], dtype=torch.int32, device=cuda)
    got = flash_decode_attention(q, k, v, lengths, ks, vs, kv_start=start,
                                 layer=1)
    torch.cuda.synchronize()
    ref = flash_decode_plain(q, k, v, lengths, ks, vs, kv_start=start,
                             layer=1)
    _assert_flash_close(got, ref, int8)
    assert (got[2] == 0).all()
    # scalar length, no kv_start (the decoder's decode-step call)
    got = flash_decode_attention(q, k, v, S - 3, ks, vs, layer=0)
    ref = flash_decode_plain(q, k, v, S - 3, ks, vs, layer=0)
    _assert_flash_close(got, ref, int8)


def _assert_flash_close(got, ref, int8):
    ref = ref.float()
    beyond = (got.float() - ref).abs() - 2 * BF16_ULP * ref.abs()
    assert beyond.max().item() <= FLASH_ATOL[int8]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D,S,scale", [
    (4, 2, 256, 300, 24.0 ** -0.5),          # gemma2-9B's g and D
    (4, 2, 256, 4096, None),                 # its window: 43,520 B of smem
    (4, 2, 128, 200, 144.0 ** -0.5)])        # gemma2-27B's g, D and scale
def test_flash_decode_softcap_and_scale(cuda, int8, nq, nkv, D, S, scale):
    """q and K shifted by 2 in every element (as chip_smoke.py's
    FLASH_OFFSET), so that the scores sit at ~43-64, where the cap of 50
    bends them, while the softmax stays spread over the slots; the result
    differs from the uncapped one beyond the limit."""
    g = _gen(nq + D + S + 7)
    B, L, cap = 4, 1, 50.0
    q = (torch.randn(B, nq, D, generator=g, device=cuda) + 2).to(
        torch.bfloat16)
    k, v, ks, vs = _cache(cuda, g, L, nkv, B, S, D, int8, pad=S % 128 != 0,
                          k_offset=2.0)
    lengths = torch.tensor([S, S // 2 + 1, 9, 1], dtype=torch.int32,
                           device=cuda)
    start = torch.tensor([0, 5, 3, 0], dtype=torch.int32, device=cuda)
    args = (q, k, v, lengths, ks, vs, start, 0)
    before = flash_decode_attention.mode_launches["softcap"]
    got = flash_decode_attention(*args, softcap=cap, scale=scale)
    torch.cuda.synchronize()
    assert flash_decode_attention.mode_launches["softcap"] == before + 1
    _assert_flash_close(got, flash_decode_plain(*args, softcap=cap,
                                                scale=scale), int8)
    uncapped = flash_decode_plain(*args, scale=scale).float()
    assert ((got.float() - uncapped).abs()
            - 2 * BF16_ULP * uncapped.abs()).max() > 2 * FLASH_ATOL[int8]
    with pytest.raises(ValueError):
        flash_decode_attention(*args, softcap=-1.0)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_peaked_softcap(cuda, int8):
    """gemma2-9B's g, D and scale with q x 3: a peaked softmax (about a
    third of a row's probability on one slot), where one flipped int8
    probability level (or bf16 probability ulp) moves a row by up to
    flash_decode_level, beyond FLASH_ATOL, so each row is held to
    PEAK_LEVELS such levels, as chip_smoke.py holds it."""
    g = _gen(int8 + 11)
    B, L, nq, nkv, D, S, cap = 8, 1, 4, 2, 256, 512, 50.0
    q = (torch.randn(B, nq, D, generator=g, device=cuda) * 3).to(
        torch.bfloat16)
    k, v, ks, vs = _cache(cuda, g, L, nkv, B, S, D, int8, pad=False)
    lengths = torch.randint(S // 2, S + 1, (B,), generator=g, device=cuda,
                            dtype=torch.int32)
    start = torch.randint(0, 32, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
    args = (q, k, v, lengths, ks, vs, start, 0)
    opts = dict(softcap=cap, scale=256.0 ** -0.5)
    got = flash_decode_attention(*args, **opts)
    torch.cuda.synchronize()
    ref = flash_decode_plain(*args, **opts).float()
    over = ((got.float() - ref).abs() - 2 * BF16_ULP * ref.abs()).amax(-1)
    assert ((over / flash_decode_level(*args, **opts)).max()
            <= PEAK_LEVELS[int8])


FLASH_CASES = [(nq, nkv, D, S, 0.0, None)
               for nq, nkv, D, S in ((4, 4, 64, 128), (8, 2, 128, 200),
                                     (32, 8, 128, 512), (2, 2, 32, 64))] + [
    (4, 2, 256, 300, 50.0, 24.0 ** -0.5), (4, 2, 256, 4096, 50.0, None),
    (4, 2, 128, 200, 50.0, 144.0 ** -0.5)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D,S,cap,scale", FLASH_CASES)
def test_flash_decode_forced_splits(cuda, int8, nq, nkv, D, S, cap, scale,
                                    splits):
    """Kernel 3 with its rows split over a cluster of R = `splits` blocks
    (int8 with g <= 2 loading to registers, the rest through the cp.async
    ring), on test_flash_decode's and the softcap test's shapes and ragged
    rows
    (lengths S, S/2 + 1, 0, 9 and 1; the second row's window start 5, the
    fourth's 3): within the limit of the plain version, one launch per
    call, and two launches of one plan bit-equal."""
    from mixq_tpu_torch.kernels.flash_decode import _flash
    g = _gen(nq + D + S + splits)
    B = 5
    q = (torch.randn(B, nq, D, generator=g, device=cuda)
         + (2 if cap else 0)).to(torch.bfloat16)
    k, v, ks, vs = _cache(cuda, g, 1, nkv, B, S, D, int8, pad=S % 128 != 0,
                          k_offset=2.0 if cap else 0.0)
    lengths = torch.tensor([S, S // 2 + 1, 0, 9, 1], dtype=torch.int32,
                           device=cuda)
    start = torch.tensor([0, 5, 0, 3, 0], dtype=torch.int32, device=cuda)
    args = (q, k, v, lengths, ks, vs, start, 0, cap, scale)
    ref = flash_decode_plain(*args[:8], softcap=cap, scale=scale)
    before = flash_decode_attention.launches
    got = _flash(*args, splits=splits)
    again = _flash(*args, splits=splits)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 2
    _assert_flash_close(got, ref, int8)
    assert torch.equal(got, again) and (got[2] == 0).all()


# (n_q, n_kv, D, S, softcap): Baichuan-13B's heads (40 of 128, MHA: 8
# interleaved extra slopes), g = 4, and ALiBi after a softcap
FLASH_ALIBI_CASES = [(40, 40, 128, 512, 0.0), (8, 2, 64, 300, 0.0),
                     (6, 6, 64, 200, 30.0)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D,S,cap", FLASH_ALIBI_CASES)
def test_flash_decode_alibi_forced_splits(cuda, int8, nq, nkv, D, S, cap,
                                          splits):
    """Kernel 3 with ALiBi (slope * slot, the slot absolute under every
    cluster cut) at R = `splits`, on ragged rows (lengths S, S/2 + 1, 0, 9
    and 1; window starts 5 and 3): each row within two bf16 ulps plus
    PEAK_LEVELS of its probability level of the plain version (ALiBi rows
    are peaked), one launch per call counted in the ALiBi mode, two
    launches bit-equal, and the plain version without the bias far
    beyond the limit."""
    from mixq_tpu_torch.kernels.flash_decode import _flash
    from mixq_tpu_torch.models.layers import alibi_slopes
    g = _gen(nq + D + S + splits + 3)
    B = 5
    q = (torch.randn(B, nq, D, generator=g, device=cuda)
         * (8.0 if cap else 1.0)).to(torch.bfloat16)
    k, v, ks, vs = _cache(cuda, g, 1, nkv, B, S, D, int8, pad=S % 128 != 0)
    lengths = torch.tensor([S, S // 2 + 1, 0, 9, 1], dtype=torch.int32,
                           device=cuda)
    start = torch.tensor([0, 5, 0, 3, 0], dtype=torch.int32, device=cuda)
    slopes = alibi_slopes(nq, torch.device(cuda))
    opts = dict(softcap=cap, alibi_slopes=slopes)
    plain_args = (q, k, v, lengths, ks, vs, start, 0)
    ref = flash_decode_plain(*plain_args, **opts).float()
    level = flash_decode_level(*plain_args, **opts)
    before = flash_decode_attention.launches
    alibi_before = flash_decode_attention.mode_launches["alibi"]
    got = _flash(*plain_args, cap, None, slopes, splits=splits)
    again = _flash(*plain_args, cap, None, slopes, splits=splits)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 2
    assert flash_decode_attention.mode_launches["alibi"] == alibi_before + 2
    assert torch.equal(got, again) and (got[2] == 0).all()

    def levels(out):
        """Each row's error beyond two ulps in its probability levels (0
        within two ulps: the empty row's level is 0 in bf16)."""
        over = ((out - ref).abs() - 2 * BF16_ULP * ref.abs()).amax(-1)
        return torch.where(over > 0, over / level, 0.0).max().item()

    assert bool(torch.isfinite(got).all())
    assert levels(got.float()) <= PEAK_LEVELS[int8]
    free = flash_decode_plain(*plain_args, softcap=cap).float()
    assert levels(free) > 10 * PEAK_LEVELS[int8]


def test_flash_decode_plan_launch(cuda):
    """The wrapper's own plan (plan_flash on the card's cluster table): one
    launch per call, bit-equal on a second call, R = 1 where the stripes
    fill the card (B = 64 at 8 kv heads) and R > 1 at B = 2."""
    from mixq_tpu_torch.kernels import flash_decode as F
    g = _gen(5)
    for B, want_split in ((64, False), (2, True)):
        q = torch.randn(B, 32, 128, generator=g,
                        device=cuda).to(torch.bfloat16)
        k, v, ks, vs = _cache(cuda, g, 1, 8, B, 640, 128, True, pad=True)
        clusters = F._clusters(0, True, 4, False, 640, 128)
        plan = F.plan_flash(B, 8, 4, 640, 128, True, _build.sm_count(0),
                            clusters)
        assert (plan.splits > 1) == want_split, plan
        before = flash_decode_attention.launches
        got = flash_decode_attention(q, k, v, 600, ks, vs, layer=0)
        again = flash_decode_attention(q, k, v, 600, ks, vs, layer=0)
        torch.cuda.synchronize()
        assert flash_decode_attention.launches == before + 2
        assert torch.equal(got, again)
        _assert_flash_close(got, flash_decode_plain(q, k, v, 600, ks, vs,
                                                    layer=0), True)
    with pytest.raises(ValueError):               # R must be 1, 2, 4 or 8
        F._flash(q, k, v, 600, ks, vs, None, 0, 0.0, None, splits=3)


def test_flash_decode_peaked_over_seeds(cuda, record_property):
    """The peaked Gemma-2-9B int8 softcap case (16/8 heads of 256, q x 3,
    its scale, cap 50; B=64, S=512, ragged lengths and window starts as
    chip_smoke.py's phase 3 makes them) over 8 seeds: every output row
    within PEAK_LEVELS of its probability level of the plain version run
    on the card and of the same plain version run on the CPU copy of the
    inputs (both divide in IEEE f32, as the kernel and Pallas do). The
    largest of each, in levels, is recorded (`peak_levels_card_plain_max`,
    `peak_levels_max`)."""
    worst = card_worst = 0.0
    for seed in range(8):
        g = _gen(100 + seed)
        B, S, nq, nkv, D, cap = 64, 512, 16, 8, 256, 50.0
        q = (torch.randn(B, nq, D, generator=g, device=cuda) * 3).to(
            torch.bfloat16)
        k, v, ks, vs = _cache(cuda, g, 1, nkv, B, S, D, True, pad=False)
        lengths = torch.randint(S // 2, S + 1, (B,), generator=g,
                                device=cuda, dtype=torch.int32)
        start = torch.minimum(
            torch.randint(0, 32, (B,), generator=g, device=cuda,
                          dtype=torch.int32), lengths - 1)
        args = (q, k, v, lengths, ks, vs, start, 0)
        opts = dict(softcap=cap, scale=256.0 ** -0.5)
        got = flash_decode_attention(*args, **opts).float().cpu()
        cpu_args = tuple(t.cpu() for t in args[:-1]) + (0,)

        def levels_beyond(ref, level):
            over = ((got - ref).abs() - 2 * BF16_ULP * ref.abs()).amax(-1)
            return (over / level.cpu()).max().item()

        levels = levels_beyond(flash_decode_plain(*cpu_args, **opts).float(),
                               flash_decode_level(*cpu_args, **opts))
        card = levels_beyond(flash_decode_plain(*args, **opts).float().cpu(),
                             flash_decode_level(*args, **opts))
        worst, card_worst = max(worst, levels), max(card_worst, card)
        assert levels <= PEAK_LEVELS[True], (seed, levels)
        assert card <= PEAK_LEVELS[True], (seed, card)
    record_property("peak_levels_max", worst)
    record_property("peak_levels_card_plain_max", card_worst)
    print(f"peaked Gemma-2-9B int8 softcap, 8 seeds: at most {worst:.3f} "
          f"probability levels of a row against the plain version on the "
          f"CPU, {card_worst:.3f} on the card (limit {PEAK_LEVELS[True]})")


def _batch_major(cuda, g, B, S, nkv, D, int8, k_offset=0.0):
    kf = torch.randn(B, S, nkv, D, generator=g, device=cuda) + k_offset
    vf = torch.randn(B, S, nkv, D, generator=g, device=cuda)
    if int8:
        (k, ks), (v, vs) = Q.quantize_kv(kf), Q.quantize_kv(vf)
        return k, v, ks, vs
    return kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None


def _assert_decode_close(got, ref):
    ref = ref.float().to(got.device)
    assert bool(torch.isfinite(got).all())
    beyond = (got.float() - ref).abs() - 2 * BF16_ULP * ref.abs()
    assert beyond.max().item() <= DECODE_ATOL


def _decode_plain_on_cpu(*args, **opts):
    """decode_attention_plain on a CPU copy of the inputs: the reference
    whose arithmetic does not depend on how the card's PyTorch runs a
    division."""
    return decode_attention_plain(*[a.cpu() if torch.is_tensor(a) else a
                                    for a in args], **opts)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv,D,S", [(4, 4, 64, 128), (8, 2, 128, 300),
                                        (32, 8, 128, 512), (2, 2, 32, 64),
                                        (16, 2, 256, 130)])
def test_decode_attention(cuda, int8, nq, nkv, D, S):
    """Per-row lengths (one of 0, one past S), starts, a row with no valid
    position (JAX's uniform softmax over all S slots), and the scalar
    length and start of the decoder's call."""
    g = _gen(nq + D + S + 3)
    B = 6
    q = torch.randn(B, nq, D, generator=g, device=cuda).to(torch.bfloat16)
    k, v, ks, vs = _batch_major(cuda, g, B, S, nkv, D, int8)
    lengths = torch.tensor([S, S // 2 + 1, 0, 9, 1, S + 7],
                           dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 5, 0, 9, 0, 3], dtype=torch.int32, device=cuda)
    modes = dict(decode_attention.mode_launches)
    got = decode_attention(q, k, v, lengths, ks, vs, start)
    torch.cuda.synchronize()
    kv = "int8" if int8 else "bf16"
    assert decode_attention.mode_launches[kv] == modes[kv] + 1
    _assert_decode_close(got, decode_attention_plain(q, k, v, lengths, ks,
                                                     vs, start))
    got = decode_attention(q, k, v, S - 3, ks, vs, 2)
    _assert_decode_close(got, decode_attention_plain(q, k, v, S - 3, ks, vs,
                                                     2))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (32, 8)])
def test_decode_attention_ring(cuda, int8, nq, nkv):
    """A ring of 300 slots read at lengths past its wrap (and one before
    it), from window starts max(start, len - W) with W = 256 and without."""
    g = _gen(nq + int8 + 5)
    B, S, D, W = 5, 300, 128, 256
    q = torch.randn(B, nq, D, generator=g, device=cuda).to(torch.bfloat16)
    k, v, ks, vs = _batch_major(cuda, g, B, S, nkv, D, int8)
    lengths = torch.tensor([S + 37, 2 * S + 299, 200, 3 * S, S + 1],
                           dtype=torch.int32, device=cuda)
    for start in (torch.zeros_like(lengths),
                  torch.clamp_min(lengths - W, 0).to(torch.int32)):
        before = decode_attention.mode_launches["ring"]
        got = decode_attention(q, k, v, lengths, ks, vs, start, ring=True)
        torch.cuda.synchronize()
        assert decode_attention.mode_launches["ring"] == before + 1
        _assert_decode_close(got, decode_attention_plain(
            q, k, v, lengths, ks, vs, start, ring=True))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("gain,offset", [(1.0, 2.0), (3.0, 0.0)])
def test_decode_attention_softcap_and_peaked(cuda, int8, gain, offset):
    """gemma2-9B's g, D and scale with the softcap of 50: q and K shifted by
    2 (the cap bends the scores), and q x 3 (a peaked softmax); held to the
    plain version run on the card and on a CPU copy of the inputs."""
    g = _gen(int8 + int(gain) + 17)
    B, nq, nkv, D, S, cap = 4, 4, 2, 256, 700, 50.0
    q = (torch.randn(B, nq, D, generator=g, device=cuda) * gain
         + offset).to(torch.bfloat16)
    k, v, ks, vs = _batch_major(cuda, g, B, S, nkv, D, int8, offset)
    lengths = torch.tensor([S, 400, 9, 650], dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 5, 3, 600], dtype=torch.int32, device=cuda)
    opts = dict(scale=256.0 ** -0.5, softcap=cap)
    got = decode_attention(q, k, v, lengths, ks, vs, start, **opts)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, k, v, lengths, ks, vs, start, **opts)
    _assert_decode_close(got, ref)
    _assert_decode_close(got, _decode_plain_on_cpu(q, k, v, lengths, ks, vs,
                                                   start, **opts))
    if offset:
        free = decode_attention_plain(q, k, v, lengths, ks, vs, start,
                                      scale=opts["scale"]).float()
        assert ((got.float() - free).abs()
                - 2 * BF16_ULP * free.abs()).max() > 10 * DECODE_ATOL


DECODE_CASES = [
    # (n_q, n_kv, D, S, ring, softcap, scale): Mistral's heads, Llama's,
    # gemma2's with the softcap, a ring read past its wrap, small heads
    (32, 8, 128, 512, False, 0.0, None), (32, 32, 128, 300, False, 0.0, None),
    (16, 8, 256, 700, False, 50.0, 256.0 ** -0.5),
    (32, 8, 128, 600, True, 0.0, None), (8, 2, 64, 200, True, 0.0, None),
    (2, 2, 32, 64, False, 0.0, None)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("nq,nkv,D,S,ring,cap,scale", DECODE_CASES)
def test_decode_attention_forced_splits(cuda, B, int8, nq, nkv, D, S, ring,
                                        cap, scale, splits):
    """Kernel 8 with each row's positions split over a cluster of R =
    `splits` blocks, on ragged rows (full, one position, past S for a
    ring, a window start, no valid position when B > 1): within the limit
    of the plain version (with the softcap, also of the plain version run
    on a CPU copy of the inputs), one launch per call, and two launches of
    one plan bit-equal."""
    from mixq_tpu_torch.kernels.decode_attention import _decode
    g = _gen(nq + D + S + B + splits + 7 * int8)
    off = 2.0 if cap else 0.0
    q = (torch.randn(B, nq, D, generator=g, device=cuda) + off).to(
        torch.bfloat16)
    k, v, ks, vs = _batch_major(cuda, g, B, S, nkv, D, int8, off)
    if ring:
        lengths = torch.randint(S + 1, 3 * S, (B,), generator=g, device=cuda,
                                dtype=torch.int32)
        starts = torch.clamp_min(lengths - S + 17, 0).to(torch.int32)
    else:
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                                dtype=torch.int32)
        starts = torch.minimum(torch.randint(0, 40, (B,), generator=g,
                                             device=cuda, dtype=torch.int32),
                               lengths - 1)
    lengths[0] = 3 * S if ring else S
    starts[0] = 0
    if B > 1:
        lengths[1], starts[1] = (S + 1, S) if ring else (1, 0)
    if B > 2:
        starts[2] = lengths[2]                   # no valid position
    opts = dict(ring=ring, softcap=cap, scale=scale)
    ref = decode_attention_plain(q, k, v, lengths, ks, vs, starts, **opts)
    before = decode_attention.launches
    args = (q, k, v, lengths, ks, vs, starts, ring, scale, cap)
    got = _decode(*args, splits=splits)
    again = _decode(*args, splits=splits)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    _assert_decode_close(got, ref)
    if cap:                     # the softcap's division, run on the CPU too
        _assert_decode_close(got, _decode_plain_on_cpu(
            q, k, v, lengths, ks, vs, starts, **opts))
    assert torch.equal(got, again)


# (n_q, n_kv, D, S, ring): Baichuan-13B's heads, g = 2 on a ring read
# past its wrap, g = 4
DECODE_ALIBI_CASES = [(40, 40, 128, 512, False), (8, 4, 64, 200, True),
                      (8, 2, 128, 300, False)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("nq,nkv,D,S,ring", DECODE_ALIBI_CASES)
def test_decode_attention_alibi_forced_splits(cuda, B, int8, nq, nkv, D, S,
                                              ring, splits):
    """Kernel 8 with ALiBi (slope * (position - q_pos), q_pos = kv_len - 1,
    added where the score is formed, before any max) at R = `splits`, on
    ragged rows (full, one position, past S for a ring, a window start, no
    valid position): within two bf16 ulps plus DECODE_ATOL of the plain
    version, one launch per call counted in the ALiBi mode, two launches
    bit-equal."""
    from mixq_tpu_torch.kernels.decode_attention import _decode
    from mixq_tpu_torch.models.layers import alibi_slopes
    g = _gen(nq + D + S + B + splits + 7 * int8 + 11)
    q = torch.randn(B, nq, D, generator=g, device=cuda).to(torch.bfloat16)
    k, v, ks, vs = _batch_major(cuda, g, B, S, nkv, D, int8)
    if ring:
        lengths = torch.randint(S + 1, 3 * S, (B,), generator=g, device=cuda,
                                dtype=torch.int32)
        starts = torch.clamp_min(lengths - S + 17, 0).to(torch.int32)
    else:
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                                dtype=torch.int32)
        starts = torch.minimum(torch.randint(0, 40, (B,), generator=g,
                                             device=cuda, dtype=torch.int32),
                               lengths - 1)
    lengths[0] = 3 * S if ring else S
    starts[0] = 0
    if B > 1:
        lengths[1], starts[1] = (S + 1, S) if ring else (1, 0)
    if B > 2:
        starts[2] = lengths[2]                   # no valid position
    slopes = alibi_slopes(nq, torch.device(cuda))
    ref = decode_attention_plain(q, k, v, lengths, ks, vs, starts, ring=ring,
                                 alibi_slopes=slopes)
    before = decode_attention.launches
    alibi_before = decode_attention.mode_launches["alibi"]
    args = (q, k, v, lengths, ks, vs, starts, ring, None, 0.0, slopes)
    got = _decode(*args, splits=splits)
    again = _decode(*args, splits=splits)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert decode_attention.mode_launches["alibi"] == alibi_before + 2
    _assert_decode_close(got, ref)
    assert torch.equal(got, again)
    free = decode_attention_plain(q, k, v, lengths, ks, vs, starts,
                                  ring=ring).float()
    assert (free - ref.float()).abs().max().item() > 100 * DECODE_ATOL


def test_decode_attention_plan_launch(cuda):
    """The wrapper's own plan (plan_decode on the card's cluster table):
    one launch per call, bit-equal on a second call, R = 1 where the
    stripes fill the card (B = 64 at 8 kv heads) and R > 1 at B = 8."""
    from mixq_tpu_torch.kernels import decode_attention as DA
    g = _gen(11)
    for B, want_split in ((64, False), (8, True)):
        q = torch.randn(B, 32, 128, generator=g,
                        device=cuda).to(torch.bfloat16)
        k, v, ks, vs = _batch_major(cuda, g, B, 640, 8, 128, True)
        clusters = DA._clusters(0, True, 4, False, 128)
        plan = DA.plan_decode(B, 8, 4, 640, 128, True, False,
                              _build.sm_count(0), clusters)
        assert (plan.splits > 1) == want_split, plan
        before = decode_attention.launches
        got = decode_attention(q, k, v, 600, ks, vs)
        again = decode_attention(q, k, v, 600, ks, vs)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 2
        assert torch.equal(got, again)
        _assert_decode_close(got, decode_attention_plain(q, k, v, 600, ks,
                                                         vs))
    with pytest.raises(ValueError):               # R must be 1, 2, 4 or 8
        DA._decode(q, k, v, 600, ks, vs, None, False, None, 0.0, splits=3)


@pytest.mark.parametrize("nq,nkv,D,int8,cap", [
    (32, 8, 128, True, False), (32, 32, 128, False, False),
    (16, 8, 256, True, True)])
def test_decode_attention_smem_on_served_heads(cuda, nq, nkv, D, int8, cap):
    """At the heads kernel 8 serves (Mistral-7B int8, Llama-2-7B bf16,
    Gemma-2-9B int8 with the softcap) a block's shared memory, the
    library's own figure, is within a launch's limit, and the card holds
    at least 4 blocks an SM."""
    from mixq_tpu_torch.kernels import decode_attention as DA
    g = nq // nkv
    assert 0 < DA.launch_smem(int8, g, D) <= 224 * 1024
    assert DA._clusters(0, int8, g, cap, D)[0] >= 4 * _build.sm_count(0)


def test_decode_attention_refusals(cuda):
    g = _gen(23)
    q = torch.randn(2, 4, 64, generator=g, device=cuda).to(torch.bfloat16)
    k, v, ks, vs = _batch_major(cuda, g, 2, 16, 2, 64, True)
    with pytest.raises(ValueError):                  # scales missing: bf16
        decode_attention(q, k, v, 8)                 # K expected
    with pytest.raises(ValueError):                  # g = 3
        decode_attention(q[:, :3].contiguous(), k[:, :, :1].contiguous(),
                         v[:, :, :1].contiguous(), 8,
                         ks[:, :, :1].contiguous(), vs[:, :, :1].contiguous())
    with pytest.raises(ValueError):                  # lengths not int32
        decode_attention(q, k, v, torch.ones(2, device=cuda), ks, vs)
    slopes = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="ALiBi with a softcap"):
        decode_attention(q, k, v, 8, ks, vs, alibi_slopes=slopes,
                         softcap=30.0)
    with pytest.raises(ValueError):                  # slopes on the host
        decode_attention(q, k, v, 8, ks, vs, alibi_slopes=slopes.cpu())
    with pytest.raises(ValueError):                  # one slope per kv head
        decode_attention(q, k, v, 8, ks, vs, alibi_slopes=slopes[:2])


# ---------------------------------------------------------------------------
# The device decode loop: replays of a CUDA graph of the decode step
# ---------------------------------------------------------------------------

def _tiny_cfg(family):
    """chip_smoke.py's phase-4 tiny models: llama, mistral (a window of 4),
    gemma2 (caps that bind, alternating windows no shorter than the cache)
    and an ALiBi llama-shaped model (baichuan: 6 heads of 64, MHA, rope
    style "none"; "baichuan flash" serves it under attn_impl="flash")."""
    from mixq_tpu_torch.config import ModelConfig

    base = dict(hidden_size=256, intermediate_size=512,
                num_attention_heads=4, num_key_value_heads=2)
    if family.startswith("baichuan"):
        return ModelConfig.tiny(model_type="baichuan", alibi=True,
                                rope_style="none", hidden_size=384,
                                intermediate_size=512, num_attention_heads=6,
                                num_key_value_heads=6)
    if family == "mistral":
        return ModelConfig.tiny(model_type="mistral", sliding_window=4,
                                **base)
    if family == "gemma2":
        return ModelConfig.tiny(
            model_type="gemma2", rms_norm_eps=1e-6,
            hidden_act="gelu_pytorch_tanh", gated_mlp=True,
            tie_word_embeddings=True, embed_multiplier=256 ** 0.5,
            post_norms=True, query_pre_attn_scalar=24.0,
            attn_logit_softcap=0.4, final_logit_softcap=1.0,
            sliding_window=128, sliding_window_pattern=2, **base)
    return ModelConfig.tiny(**base)


def _tiny_engine(cuda, family, precision, kv_dtype="int8", **ecfg):
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig, QuantConfig
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.models.decoder import (DecoderSpecs,
                                               init_decoder_params)
    from mixq_tpu_torch.ops.mixed_linear import LinearSpec
    from mixq_tpu_torch.quantize import resolve_specs

    cfg = _tiny_cfg(family)
    specs = {"W8A8": lambda: DecoderSpecs.uniform(LinearSpec(w_bit=8,
                                                             a_bit=8)),
             "W4A4": lambda: resolve_specs(QuantConfig.w4a4(
                 outlier_budget=16)),
             "W8A16": lambda: resolve_specs(QuantConfig.w8a16())}[
                 precision]()
    if family.endswith(" flash"):
        specs = dataclasses.replace(specs, attn_impl="flash")
    params = init_decoder_params(cfg, specs, _gen(0), device=cuda,
                                 dtype=torch.bfloat16, outlier_budget=16)
    return InferenceEngine(params, cfg, specs, EngineConfig(
        max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype, **ecfg),
        device=cuda)


def _stepwise(eng):
    import copy
    import dataclasses

    other = copy.copy(eng)
    other.engine_cfg = dataclasses.replace(eng.engine_cfg,
                                           device_decode_loop=False)
    return other


LOOP_CASES = [(f, p) for f in ("llama", "mistral", "gemma2")
              for p in ("W8A8", "W4A4", "W8A16")] + [
    ("baichuan", "W8A8"), ("baichuan flash", "W8A8")]
LOOP_PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13],
                [42]]


@pytest.mark.parametrize("family,precision", LOOP_CASES)
def test_graph_generate_equals_stepwise(cuda, family, precision,
                                        monkeypatch):
    """generate through the graph (the default) equals the stepwise host
    loop on the same engine token for token: greedy, greedy with an EOS
    read every 2 steps, and sampled (temperature, top-k, top-p) from one
    seed, with logprobs; the graph path captured once a call and never
    ran the stepwise loop. The wrappers counted one prefill, the eager
    step and the captured one; the card ran (profiler, by kernel name)
    one prefill and new - 1 decode steps."""
    from torch.autograd import DeviceType

    from mixq_tpu_torch.engine import SamplingParams
    from mixq_tpu_torch.engine import engine as engine_mod
    from mixq_tpu_torch.engine.engine import DecodeLoop
    from mixq_tpu_torch.kernels import (card_trace, executed_counts,
                                        launch_counts, reset_launch_counts)

    eng = _tiny_engine(cuda, family, precision)
    step = _stepwise(eng)
    captures = []
    real = DecodeLoop.capture
    monkeypatch.setattr(DecodeLoop, "capture",
                        lambda self: captures.append(1) or real(self))
    new = 12
    ref = step.generate(LOOP_PROMPTS, new)
    eos = ref[0][3]
    ref_eos = step.generate(LOOP_PROMPTS, new, eos_token_id=eos)
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95)
    ref_sp = step.generate(LOOP_PROMPTS, new, sampling=sp, seed=5,
                           return_logprobs=True)
    monkeypatch.setattr(type(eng), "_stepwise", None)     # refused
    reset_launch_counts()
    with card_trace() as prof:
        got = eng.generate(LOOP_PROMPTS, new)
    per_call = {k: v for k, v in launch_counts().items() if v}
    ran = executed_counts((e.key, e.count) for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA)
    assert got == ref and len(captures) == 1
    monkeypatch.setattr(engine_mod, "DEFAULT_WINDOW", 2)
    assert eng.generate(LOOP_PROMPTS, new, eos_token_id=eos) == ref_eos
    assert ref_eos[0][-1] == eos and len(ref_eos[0]) <= 4
    assert eng.generate(LOOP_PROMPTS, new, sampling=sp, seed=5,
                        return_logprobs=True) == ref_sp
    L = eng.model_cfg.num_hidden_layers
    attn = ("flash_decode" if eng.new_cache(4, 128).head_major
            else "decode_attention")
    norms = 0 if precision == "W8A16" else 2 * L
    assert per_call[attn] == L * 2
    assert per_call.get("rmsnorm_quant", 0) == norms * 3
    assert ran[attn] == L * (new - 1)
    assert ran["rmsnorm_quant"] == norms * new


@pytest.mark.parametrize("family,precision", LOOP_CASES)
def test_graph_replay_logits_bit_equal(cuda, family, precision):
    """Two caches from the same prefill: one runs 8 eager steps, the other
    one eager step, the capture and 7 replays; every step's logits, the
    tokens and the caches bit-equal. mistral's cache is an 8-slot ring
    past its wrap."""
    from mixq_tpu_torch.engine import SamplingParams
    from mixq_tpu_torch.engine.engine import DecodeLoop

    eng = _tiny_engine(cuda, family, precision)
    B, steps = 3, 8
    slots = 8 if family == "mistral" else 64
    toks = torch.randint(1, eng.model_cfg.vocab_size, (B, 8),
                         generator=_gen(9), device=cuda)
    kv_start = torch.tensor([0, 2, 5], dtype=torch.int32, device=cuda)
    runs = []
    for graphed in (False, True):
        cache = eng.new_cache(B, slots)
        logits, cache = eng.prefill(toks, cache, kv_start)
        tok = torch.argmax(logits, -1).to(torch.int32)
        loop = DecodeLoop(eng, cache, kv_start, tok, steps + 1,
                          SamplingParams(), None)
        out = [loop.step().clone()]
        for _ in range(steps - 1):
            if graphed:
                if loop.graph is None:
                    loop.capture()
                loop.replay()
                out.append(loop.logits.clone())
            else:
                out.append(loop.step().clone())
        torch.cuda.synchronize()
        runs.append((out, loop.tokens.clone(), cache))
    (eager, t_e, c_e), (graph, t_g, c_g) = runs
    assert all(torch.equal(a, b) for a, b in zip(eager, graph))
    assert torch.equal(t_e, t_g)
    assert c_g.host_length == int(c_g.length) == 8 + steps
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(c_e, f), getattr(c_g, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("family,precision", LOOP_CASES)
def test_decode_step_syncs_nothing(cuda, family, precision):
    """The step (greedy, and sampled with logprobs and an EOS mask) under
    torch.cuda.set_sync_debug_mode("error"), after a warm-up step."""
    from mixq_tpu_torch.engine import SamplingParams
    from mixq_tpu_torch.engine.engine import DecodeLoop
    from mixq_tpu_torch.engine.sampling import chosen_logprob, sample

    eng = _tiny_engine(cuda, family, precision)
    toks = torch.randint(1, eng.model_cfg.vocab_size, (3, 8),
                         generator=_gen(4), device=cuda)
    for sp in (SamplingParams(), SamplingParams(temperature=0.8, top_k=20,
                                                top_p=0.9)):
        cache = eng.new_cache(3, 64)
        logits, cache = eng.prefill(toks, cache)
        gen = torch.Generator(device=cuda).manual_seed(1)
        tok = sample(logits, gen, sp)
        loop = DecodeLoop(eng, cache, eng._rows(None, 3), tok, 4, sp, gen,
                          eos_token_id=7,
                          first_lp=chosen_logprob(logits, tok))
        loop.step()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop.step()
            loop.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert cache.host_length == int(cache.length) == 11


# ---------------------------------------------------------------------------
# The quantization pipeline and the online outlier predictor on the card
# ---------------------------------------------------------------------------

def test_top_indices_ties_on_the_card(cuda):
    """A descending stable sort on CUDA keeps the lower index first among
    ties, as on the CPU (and as jax.lax.top_k): the calibration pick and
    the detector choose the CPU's channels, in its order."""
    g = torch.Generator().manual_seed(3)
    for levels in (3, 20):
        s = torch.randint(0, levels, (4096,), generator=g).float()
        idx = Q.top_indices(s.to(cuda), 128)
        assert torch.equal(idx.cpu(), Q.top_indices(s, 128))
        card = Q.top_k_outliers_from_scales(s.to(cuda), 128, 4096, 128)
        cpu = Q.top_k_outliers_from_scales(s, 128, 4096, 128)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
        m = s * 0.7                           # many ties past sigma = 6
        start = Q.empty_outlier_set(4096, 64, device="cpu")
        card = Q.detect_new_outliers_from_absmax(
            m.to(cuda), Q.OutlierSet(*(t.to(cuda) for t in start)), 6.0)
        cpu = Q.detect_new_outliers_from_absmax(m, start, 6.0)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


def _hf_state(cfg, boost_channels=(7, 100), boost=10.0):
    """A seeded HF-named float state dict of a llama (CPU tensors), with
    embedding channels boosted into outliers."""
    g = torch.Generator().manual_seed(11)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)

    def w(*shape, s=0.05):
        return torch.randn(shape, generator=g) * s

    d = {"model.embed_tokens.weight": w(V, H, s=0.02),
         "model.norm.weight": torch.ones(H), "lm_head.weight": w(V, H, s=0.02)}
    d["model.embed_tokens.weight"][:, list(boost_channels)] += boost
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        d[p + "input_layernorm.weight"] = torch.ones(H)
        d[p + "post_attention_layernorm.weight"] = torch.ones(H)
        for name, shape in (("self_attn.q_proj", (nq * hd, H)),
                            ("self_attn.k_proj", (nkv * hd, H)),
                            ("self_attn.v_proj", (nkv * hd, H)),
                            ("self_attn.o_proj", (H, nq * hd)),
                            ("mlp.gate_proj", (I, H)),
                            ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))):
            d[p + name + ".weight"] = w(*shape)
    return d


def _tensors(obj):
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for x in obj for t in _tensors(x)]


def _assert_params_equal(card, cpu):
    a, b = _tensors(card), _tensors(cpu)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.device.type == "cuda" and x.dtype == y.dtype
        assert torch.equal(x.cpu(), y)


def test_quantize_and_warmup_on_the_card_equal_the_cpu(cuda):
    """quantize_model (W8A8, empty sets) of a state dict on the card is
    bit-equal to the CPU's of the same dict; warmup_online then gives the
    CPU's counts, sets and promoted params. The stats forwards of the two
    devices may differ in summation order: every channel's maximum is
    asserted farther from sigma than they differ."""
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.hf import TensorSource
    from mixq_tpu_torch.quantize import (quantize_model,
                                         warmup_online_outliers)

    cfg = _tiny_cfg("llama")
    state = _hf_state(cfg)
    qcfg = QuantConfig.w8a8(outlier_budget=16)
    sd_card = {k: v.to(cuda, torch.bfloat16) for k, v in state.items()}
    sd_cpu = {k: v.to(torch.bfloat16) for k, v in state.items()}
    card, specs = quantize_model(TensorSource.from_torch_state_dict(sd_card),
                                 cfg, qcfg, device=cuda)
    cpu, _ = quantize_model(TensorSource.from_torch_state_dict(sd_cpu), cfg,
                            qcfg, device="cpu")
    _assert_params_equal(card, cpu)
    g = torch.Generator().manual_seed(2)
    batches = [torch.randint(1, cfg.vocab_size, (4, 16), generator=g)
               for _ in range(2)]
    logs = {"card": [], "cpu": []}
    wc, counts_card = warmup_online_outliers(card, cfg, specs, batches,
                                             stats_log=logs["card"])
    wp, counts_cpu = warmup_online_outliers(cpu, cfg, specs, batches,
                                            stats_log=logs["cpu"])
    for a, b in zip(logs["card"], logs["cpu"]):
        spread = max((a[k].cpu() - b[k]).abs().max().item() for k in b)
        margin = min((b[k] - 6.0).abs().min().item() for k in b)
        assert margin > spread, (margin, spread)
    assert counts_card == counts_cpu and sum(counts_cpu.values()) > 0
    _assert_params_equal(wc, wp)


def test_calibrated_w4a4_on_the_card(cuda):
    """4-bit quantize_model on the card: from the CPU's act scales, params
    bit-equal to the CPU's; from calibration batches on the card, the card's
    scales within 2e-2 of the CPU's per key and the sets equal wherever the
    gap at the cut exceeds the two devices' difference."""
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.decoder import DecoderSpecs
    from mixq_tpu_torch.models.hf import TensorSource, params_from_source
    from mixq_tpu_torch.quantize import (collect_act_scales,
                                         outlier_sets_from_scales,
                                         quantize_model)

    cfg = _tiny_cfg("llama")
    state = _hf_state(cfg, boost_channels=tuple(range(0, 64, 4)))
    qcfg = QuantConfig.w4a4(outlier_budget=16)
    src_cpu = TensorSource.from_dict(state)
    src_card = TensorSource.from_torch_state_dict(
        {k: v.to(cuda) for k, v in state.items()})
    g = torch.Generator().manual_seed(6)
    batches = [torch.randint(1, cfg.vocab_size, (2, 16), generator=g)
               for _ in range(2)]
    s_cpu = collect_act_scales(params_from_source(
        src_cpu, cfg, DecoderSpecs.fp16(), device="cpu"), cfg, batches)
    cpu, _ = quantize_model(src_cpu, cfg, qcfg, act_scales=s_cpu,
                            device="cpu")
    card, _ = quantize_model(src_card, cfg, qcfg, act_scales=s_cpu,
                             device=cuda)
    _assert_params_equal(card, cpu)
    s_card = collect_act_scales(params_from_source(
        src_card, cfg, DecoderSpecs.fp16(), device=cuda), cfg, batches)
    sets_card = outlier_sets_from_scales(s_card, qcfg, device=cuda)
    sets_cpu = outlier_sets_from_scales(s_cpu, qcfg, device="cpu")
    for k, b in s_cpu.items():
        a = s_card[k]
        assert a.device.type == "cuda"
        diff = (a.cpu() - b).abs().max().item()
        assert diff <= 2e-2 * b.abs().max().item(), (k, diff)
        cut = torch.sort(b, descending=True).values
        if cut[15] - cut[16] > diff:
            assert (set(sets_card[k].ind.tolist())
                    == set(sets_cpu[k].ind.tolist())), k
    calibrated, _ = quantize_model(src_card, cfg, qcfg, calib_batches=batches,
                                   device=cuda)
    assert calibrated.blocks[0].attn.wq.q_weight.device.type == "cuda"


def test_collect_stats_adds_no_sync_and_leaves_the_step_graph(cuda):
    """A decode step with collect_stats=True syncs nothing (set_sync_debug_
    mode("error")). With it off, a replay of the captured step runs the
    eager step's kernels, name for name and count for count; the stats
    forward runs more (its reductions)."""
    from torch.autograd import DeviceType

    from mixq_tpu_torch.engine import SamplingParams
    from mixq_tpu_torch.engine.engine import DecodeLoop
    from mixq_tpu_torch.kernels import card_trace
    from mixq_tpu_torch.models.decoder import forward

    eng = _tiny_engine(cuda, "llama", "W8A8")
    toks = torch.randint(1, eng.model_cfg.vocab_size, (3, 8),
                         generator=_gen(4), device=cuda)
    cache = eng.new_cache(3, 64)
    logits, cache = eng.prefill(toks, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    loop = DecodeLoop(eng, cache, eng._rows(None, 3), tok, 6,
                      SamplingParams(), None)
    loop.step()
    kv_start = eng._rows(None, 3)

    def stats_step():
        with torch.inference_mode():
            return forward(eng.params, loop.tok, cache, eng.specs,
                           eng.model_cfg, kv_start, head_f32=eng.head_f32,
                           collect_stats=True)

    stats_step()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, stats = stats_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(stats) == 4 * eng.model_cfg.num_hidden_layers

    def kernels(run):
        torch.cuda.synchronize()
        with card_trace() as prof:
            run()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    eager = kernels(loop.step)
    loop.capture()
    graph = kernels(loop.replay)
    assert graph == eager
    with_stats = kernels(stats_step)
    assert sum(with_stats.values()) > sum(eager.values())


# ---------------------------------------------------------------------------
# Continuous batching: the slot pool's ragged rows, the slot-mode forward,
# the CB engine's windows as graph replays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("head_major", [True, False])
def test_pool_rows_at_length_1_and_S(cuda, head_major, splits):
    """A CB pool's decode at Llama-2-7B's heads (32 of 128): kernel 3 (int8,
    head-major) and kernel 8 (bf16, batch-major) with rows of kv_len 1 and
    S = 640 and ragged ones between in one launch and no kv_start (a pool
    row starts at 0), at every cluster size R: a row of length 1 leaves
    R - 1 ranks an empty part. Within each kernel's limit of its plain
    version."""
    from mixq_tpu_torch.kernels.decode_attention import _decode
    from mixq_tpu_torch.kernels.flash_decode import _flash
    g = _gen(640 + splits + head_major)
    B, S, n, D = 16, 640, 32, 128
    q = torch.randn(B, n, D, generator=g, device=cuda).to(torch.bfloat16)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                            dtype=torch.int32)
    lengths[0], lengths[1], lengths[2] = 1, S, 2
    if head_major:
        k, v, ks, vs = _cache(cuda, g, 1, n, B, S, D, True, pad=True)
        got = _flash(q, k, v, lengths, ks, vs, None, 0, 0.0, None,
                     splits=splits)
        _assert_flash_close(got, flash_decode_plain(q, k, v, lengths, ks,
                                                    vs, layer=0), True)
    else:
        k, v, ks, vs = _batch_major(cuda, g, B, S, n, D, False)
        got = _decode(q, k, v, lengths, ks, vs, None, False, None, 0.0,
                      splits=splits)
        _assert_decode_close(got, decode_attention_plain(q, k, v, lengths,
                                                         ks, vs))
    torch.cuda.synchronize()


def _cb_world(cuda):
    """The tiny W8A8 llama of the loop tests, on the CPU and the same
    parameters on the card."""
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.models.decoder import (DecoderSpecs,
                                               init_decoder_params)
    from mixq_tpu_torch.ops.mixed_linear import LinearSpec

    cfg = _tiny_cfg("llama")
    specs = DecoderSpecs.uniform(LinearSpec(w_bit=8, a_bit=8))
    cpu = init_decoder_params(cfg, specs, torch.Generator().manual_seed(3),
                              device="cpu", outlier_budget=16)
    return cfg, specs, cpu, params_to(cpu, cuda)


CB_LAYOUTS = [("flash", "int8"), ("auto", "bfloat16"), ("auto", "int8")]


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS)
def test_slot_forward_on_the_card_equals_the_cpu(cuda, attn, kv):
    """forward(slot_lengths) at ragged lengths (0 to 20 after a prefill of
    16), 3 steps, on the card and on the CPU: logits within phase 4's
    limits for the tiny llama (1e-5 of max|logits| on the head-major cache,
    where the card's W8A8 run equals the CPU's block by block; 1.35e-2 on
    the batch-major one, where kernel 8 and the prefill's attention over
    the cache sum in another order); on the same caches the slot-mode step
    at one length for every row bit-equal to the scalar-length step."""
    import dataclasses

    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.layers import KVCache

    cfg, specs, cpu, card = _cb_world(cuda)
    specs = dataclasses.replace(specs, attn_impl=attn)
    toks = torch.randint(1, cfg.vocab_size, (4, 20),
                         generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([16, 3, 0, 12], dtype=torch.int32)
    hm = attn == "flash"
    logits = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        head = lm_head_f32(params, specs)
        cache = KVCache.create(cfg.num_hidden_layers, 4, 64,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               getattr(torch, kv), head_major=hm, device=dev)
        t = toks.to(dev)
        with torch.inference_mode():
            forward(params, t[:, :16], cache, specs, cfg, head_f32=head)
            out = []
            for i in range(3):
                lg, _ = forward(params, t[:, 16 + i:17 + i], cache, specs,
                                cfg, head_f32=head,
                                slot_lengths=(lengths + i).to(dev))
                out.append(lg.cpu())
            # every row at 16: slot mode bit-equal to the scalar forward
            even, _ = forward(params, t[:, 19:], cache, specs, cfg,
                              head_f32=head, slot_lengths=torch.full(
                                  (4,), 16, dtype=torch.int32, device=dev))
            scalar, _ = forward(params, t[:, 19:], cache, specs, cfg,
                                head_f32=head)
        assert torch.equal(even, scalar)
        logits.append(torch.stack(out))
    ref, got = logits
    tol = 1e-5 if hm else 1.35e-2
    assert (got - ref).abs().max() <= tol * ref.abs().max()


def _cb_serve(params, cfg, specs, dev, attn, kv, windowed=True, sampled=(),
              seed=11):
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import SamplingParams
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        params, cfg, dataclasses.replace(specs, attn_impl=attn),
        EngineConfig(max_batch_size=4, max_seq_len=64, prefill_chunk=8,
                     kv_dtype=kv, device_decode_loop=windowed), device=dev)
    ids = []
    for i, prompt in enumerate(_cb_prompts(cfg, seed)):
        sp = (SamplingParams(temperature=0.8, top_k=20, top_p=0.9)
              if i in sampled else None)
        ids.append(eng.add_request(prompt, 4 + i, sampling=sp))
    out = eng.run_to_completion()
    return eng, [out[i] for i in ids]


def _cb_prompts(cfg, seed):
    """The 9 prompts of _cb_serve, of 1 to 19 tokens."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, cfg.vocab_size,
                          (int(torch.randint(1, 20, (1,), generator=g)),),
                          generator=g).tolist() for _ in range(9)]


def _cb_replay(params, cfg, specs, dev, kv, prompt, toks):
    """A request teacher-forced as the pool serves it (its prompt but the
    last token, then one token a step) on a cache of the pool's layout:
    the logits [steps, V] on the host."""
    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, specs, EngineConfig(
        max_seq_len=64, prefill_chunk=8, kv_dtype=kv), device=dev)
    cache = eng.new_cache(1, 64)
    if len(prompt) > 1:
        eng.prefill(torch.tensor([prompt[:-1]]), cache)
    steps = []
    for t in [prompt[-1]] + toks[:-1]:
        lg, cache = eng.decode_step(torch.tensor([[t]]), cache)
        steps.append(lg[0].float().cpu())
    return torch.stack(steps)


def cb_card_vs_cpu(cfg, specs, cpu, card, cuda, attn, kv, seed=11):
    """_cb_serve's script (prompts from `seed`) on the CPU and on the card,
    then each request's CPU tokens replayed teacher-forced on both: the
    card's engine and, per request, (the largest logits gap over the
    replay's max|logits|, the steps before the first whose top-2 margin
    (the CPU's logits) is not above twice its card-vs-CPU gap, whether the
    card's served tokens equal the CPU's over those steps)."""
    import dataclasses

    _, ref = _cb_serve(cpu, cfg, specs, "cpu", attn, kv, seed=seed)
    eng, got = _cb_serve(card, cfg, specs, cuda, attn, kv, seed=seed)
    specs = dataclasses.replace(specs, attn_impl=attn)
    out = []
    for prompt, r, g in zip(_cb_prompts(cfg, seed), ref, got):
        lr, lg = (_cb_replay(p, cfg, specs, d, kv, prompt, r)
                  for p, d in ((cpu, "cpu"), (card, cuda)))
        gaps = (lg - lr).abs().amax(-1)
        top2 = torch.topk(lr, 2, dim=-1).values
        near = ((top2[:, 0] - top2[:, 1]) <= 2 * gaps).nonzero()
        n = int(near[0]) if len(near) else len(r)
        out.append(((gaps.max() / lr.abs().max()).item(), n,
                    g[:n] == r[:n]))
    return eng, out


# chip_smoke.py's CB_TINY_TOL
CB_TINY_TOL = 1.6e-2


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS)
def test_cb_tokens_on_the_card_equal_the_cpu(cuda, attn, kv):
    """The CB engine (9 requests of 1 to 19 prompt tokens on 4 slots,
    windows of 8) on the card, through the kernels and graph replays, and
    on the CPU; the graph was captured once. Each request's CPU tokens
    replayed teacher-forced on both devices (cb_card_vs_cpu): every step's
    logits within CB_TINY_TOL of max|logits| (a bf16 ulp that kernel 3 or
    8 leaves from its plain version can flip an int8 activation or KV
    entry, which moves the logits by ~1e-2), and the card's tokens equal
    the CPU's up to the request's first near-tie: before it the argmaxes
    must agree, from it a near-tie may go either way."""
    cfg, specs, cpu, card = _cb_world(cuda)
    eng, held = cb_card_vs_cpu(cfg, specs, cpu, card, cuda, attn, kv)
    assert eng.cache.head_major == (attn == "flash")
    assert list(eng._graphs) == [False]
    for i, (gap, n, equal) in enumerate(held):
        assert gap <= CB_TINY_TOL and equal, (i, gap, n)


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS[:2])
def test_cb_graph_windows_equal_eager_steps(cuda, attn, kv):
    """On the card, windows as graph replays give the tokens of eager
    single steps; with two sampled requests in the pool the greedy rows
    stay the same and a second graph (the sampling mode, the generator
    registered) is captured."""
    cfg, specs, _, card = _cb_world(cuda)
    _, steps = _cb_serve(card, cfg, specs, cuda, attn, kv, windowed=False)
    eng, windows = _cb_serve(card, cfg, specs, cuda, attn, kv)
    assert windows == steps
    eng, mixed = _cb_serve(card, cfg, specs, cuda, attn, kv,
                           sampled=(2, 5))
    greedy = [i for i in range(9) if i not in (2, 5)]
    assert [mixed[i] for i in greedy] == [steps[i] for i in greedy]
    assert sorted(eng._graphs) == [False, True]


# ---------------------------------------------------------------------------
# Speculative serving, async windows, snapshot/restore and warmup on the card
# ---------------------------------------------------------------------------

def _spec_prompts(cfg, seed=21):
    """8 repetitive prompts (a base of 2-5 tokens repeated, 4-18 tokens),
    so that n-gram drafts recur."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i in range(8):
        base = torch.randint(1, cfg.vocab_size, (2 + i % 4,),
                             generator=g).tolist()
        out.append((base * 6)[:4 + 2 * i])
    return out


def _spec_engine(params, cfg, specs, dev, attn, kv, **kw):
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

    return ContinuousBatchingEngine(
        params, cfg, dataclasses.replace(specs, attn_impl=attn),
        EngineConfig(max_batch_size=4, max_seq_len=64, prefill_chunk=8,
                     kv_dtype=kv, **kw), device=dev)


def _spec_serve(eng, cfg, step, sampled=(), snap=None):
    """The 8 prompts with budgets 6-13 through `step` until done; with
    `snap` (a function of the engine), the engine it returns after the
    second call carries on. Returns (engine, tokens by request)."""
    from mixq_tpu_torch.engine import SamplingParams

    ids = [eng.add_request(p, 6 + i, sampling=SamplingParams(
        temperature=0.8, top_k=20) if i in sampled else None)
        for i, p in enumerate(_spec_prompts(cfg))]
    out, calls = {}, 0
    while eng.has_work:
        getattr(eng, step)()
        out.update(eng.finished())
        calls += 1
        if calls == 2 and snap is not None:
            eng = snap(eng)
    out.update(eng.finished())
    return eng, [out[i] for i in ids]


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS[:2])
def test_spec_window_graph_equals_step_spec(cuda, attn, kv):
    """The spec window (one captured round, replayed spec_window_r times,
    drafting on the card) gives the tokens of step_spec (host drafts, an
    eager verify), whose T=4 verify runs at the same shapes; a sampled
    pair rides along without moving the greedy rows, and the sampling
    round is a second graph. Drafts are accepted."""
    cfg, specs, _, card = _cb_world(cuda)
    _, host = _spec_serve(_spec_engine(card, cfg, specs, cuda, attn, kv,
                                       spec_k=4), cfg, "step_spec")
    eng, win = _spec_serve(_spec_engine(card, cfg, specs, cuda, attn, kv,
                                        spec_k=4), cfg, "step_spec_window")
    assert win == host
    assert list(eng._spec_graphs) == [False] and not eng._graphs
    assert eng.spec_stats["accepted"] > 0
    eng, mixed = _spec_serve(_spec_engine(card, cfg, specs, cuda, attn, kv,
                                          spec_k=4), cfg, "step_spec_window",
                             sampled=(1, 6))
    greedy = [i for i in range(8) if i not in (1, 6)]
    assert [mixed[i] for i in greedy] == [win[i] for i in greedy]
    assert sorted(eng._spec_graphs) == [False, True]


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS)
def test_verify_on_the_card_equals_steps_and_the_cpu(cuda, attn, kv):
    """A T=4 slot-mode verify at ragged lengths (0 to 16 after a prefill of
    16) on the random tiny llama, whose attention moves its logits: on the
    card within test_slot_forward_on_the_card_equals_the_cpu's limits of
    the CPU's verify (held against JAX's by test_torch_slot_verify.py),
    and within CB_TINY_TOL of max|logits| of four T=1 slot steps of the
    same tokens on a cache prefilled alike, argmaxes equal wherever the
    steps' top-2 margin clears twice the gap; the verify one position late
    leaves the steps by ten times that gap."""
    import dataclasses

    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.layers import KVCache

    cfg, specs, cpu, card = _cb_world(cuda)
    specs = dataclasses.replace(specs, attn_impl=attn)
    toks = torch.randint(1, cfg.vocab_size, (4, 20),
                         generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([16, 3, 0, 12], dtype=torch.int32)
    hm = attn == "flash"

    def run(params, dev, at, steps=False):
        head = lm_head_f32(params, specs)
        cache = KVCache.create(cfg.num_hidden_layers, 4, 64,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               getattr(torch, kv), head_major=hm, device=dev)
        t, at = toks.to(dev), at.to(dev)
        with torch.inference_mode():
            forward(params, t[:, :16], cache, specs, cfg, head_f32=head)
            if not steps:
                return forward(params, t[:, 16:], cache, specs, cfg,
                               head_f32=head, slot_lengths=at)[0].cpu()
            return torch.cat([forward(
                params, t[:, 16 + i:17 + i], cache, specs, cfg,
                head_f32=head, slot_lengths=at + i)[0].cpu()
                for i in range(4)], 1)

    ref = run(cpu, "cpu", lengths)
    got = run(card, cuda, lengths)
    steps = run(card, cuda, lengths, steps=True)
    late = run(card, cuda, lengths + 1)
    tol = 1e-5 if hm else 1.35e-2
    assert (got - ref).abs().max() <= tol * ref.abs().max()
    gaps = (got - steps).abs().amax(-1)
    gap = gaps.max() / steps.abs().max()
    assert gap <= CB_TINY_TOL
    top2 = torch.topk(steps, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * gaps
    assert clear.any()
    assert torch.equal(got.argmax(-1)[clear], steps.argmax(-1)[clear])
    assert (late - steps).abs().max() / steps.abs().max() >= 10 * gap


def test_verify_launches_kernel_3_per_token(cuda):
    """A T=4 verify forward on the head-major int8 cache launches kernel 3
    T x L times, at per-row lengths slot_lengths + t + 1, each launch
    within its limit of the plain version on the same cache (the verify's
    tokens all written first)."""
    import dataclasses

    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.kernels import flash_decode as FD
    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.layers import KVCache

    cfg, specs, _, card = _cb_world(cuda)
    specs = dataclasses.replace(specs, attn_impl="flash")
    L, T = cfg.num_hidden_layers, 4
    cache = KVCache.create(L, 4, 64, cfg.num_key_value_heads, cfg.head_dim_,
                           torch.int8, head_major=True, device=cuda)
    toks = torch.randint(1, cfg.vocab_size, (4, 20), device=cuda,
                         generator=_gen(7))
    lengths = torch.tensor([16, 3, 0, 12], dtype=torch.int32, device=cuda)
    calls = []
    real = FD.flash_decode_attention

    def spy(q, k, v, lens, *a, **kw):
        out = real(q, k, v, lens, *a, **kw)
        ref = flash_decode_plain(q, k, v, lens, *a, **kw)
        calls.append(lens.clone())
        _assert_flash_close(out, ref, True)
        return out

    import mixq_tpu_torch.models.decoder as D
    with torch.inference_mode():
        head = lm_head_f32(card, specs)
        forward(card, toks[:, :16], cache, specs, cfg, head_f32=head)
        reset_launch_counts()
        D.flash_decode_attention = spy
        try:
            forward(card, toks[:, 16:], cache, specs, cfg, head_f32=head,
                    slot_lengths=lengths)
        finally:
            D.flash_decode_attention = real
    torch.cuda.synchronize()
    assert launch_counts()["flash_decode"] == T * L == len(calls)
    for i, lens in enumerate(calls):
        assert torch.equal(lens, lengths + i % T + 1)


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS[:2])
def test_async_windows_on_the_card_equal_sync(cuda, attn, kv):
    """Async windows (the next window dispatched before the last is read,
    its outputs through pinned buffers behind an event) give the
    synchronous windows' tokens, slots reused and admissions between
    windows."""
    cfg, specs, _, card = _cb_world(cuda)
    _, sync = _cb_serve(card, cfg, specs, cuda, attn, kv)
    import dataclasses

    from mixq_tpu_torch.config import EngineConfig
    from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(
        card, cfg, dataclasses.replace(specs, attn_impl=attn),
        EngineConfig(max_batch_size=4, max_seq_len=64, prefill_chunk=8,
                     kv_dtype=kv, async_windows=True), device=cuda)
    ids = [eng.add_request(p, 4 + i)
           for i, p in enumerate(_cb_prompts(cfg, 11))]
    out = eng.run_to_completion()
    eng.drain_async()
    assert [out[i] for i in ids] == sync
    assert eng._async_host[0][0].is_pinned()


@pytest.mark.parametrize("attn,kv", CB_LAYOUTS[:2])
def test_warmup_snapshot_restore_on_the_card(cuda, attn, kv, tmp_path):
    """A spec engine warmed up (the admission plans of JAX's buckets, the
    plain and spec windows' graphs of both sampling modes) captures no
    graph while it serves step_serve's script; a snapshot after two calls
    restored into a new engine carries on with the uninterrupted run's
    tokens, sampled rows included (the generator's state)."""
    cfg, specs, _, card = _cb_world(cuda)

    def engine():
        return _spec_engine(card, cfg, specs, cuda, attn, kv, spec_k=4)

    eng = engine()
    n = eng.warmup()
    # Tp in {8, ..., 64} x k in {1, 2, 4}, plus 4 graphs
    assert n == 8 * 3 + 4 and eng.captures == 4
    eng, ref = _spec_serve(eng, cfg, "step_serve", sampled=(3,))
    assert eng.captures == 4

    def snap(e):
        e.snapshot(str(tmp_path / "s"))
        import dataclasses

        from mixq_tpu_torch.config import EngineConfig
        from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
        return ContinuousBatchingEngine.restore(
            str(tmp_path / "s"), card, cfg,
            dataclasses.replace(specs, attn_impl=attn), EngineConfig(
                max_batch_size=4, max_seq_len=64, prefill_chunk=8,
                kv_dtype=kv, spec_k=4), device=cuda)

    _, unwarmed = _spec_serve(engine(), cfg, "step_serve", sampled=(3,))
    _, got = _spec_serve(engine(), cfg, "step_serve", sampled=(3,),
                         snap=snap)
    assert got == ref == unwarmed


# ---------------------------------------------------------------------------
# Evaluation on the card (eval/)
# ---------------------------------------------------------------------------

def _eval_model(cuda, qcfg):
    """The tiny gate's shapes (H = 256, I = 704, 2 layers, V = 2048) from
    random_hf_state with function-preserving outlier channels, quantized
    on the card (4-bit: calibrated on the card); with its CPU copy."""
    import dataclasses

    import numpy as np

    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.models.decoder import DecoderSpecs
    from mixq_tpu_torch.models.hf import params_from_source
    from mixq_tpu_torch.quantize import quantize_model
    from mixq_tpu_torch.utils.substrate import (plant_outlier_channels,
                                                substrate_cfg)
    from mixq_tpu_torch.utils.testing import DictSource, random_hf_state

    cfg = dataclasses.replace(substrate_cfg("tiny"), num_hidden_layers=2)
    state = plant_outlier_channels(random_hf_state(cfg, seed=4), cfg,
                                   [5, 77, 200], gain=8.0,
                                   inner_channels=[9, 300])
    calib = [np.random.RandomState(i).randint(2, cfg.vocab_size, (4, 64))
             for i in range(2)]
    if qcfg is None:
        specs = DecoderSpecs.fp16()
        card = params_from_source(DictSource(state), cfg, specs, device=cuda)
    else:
        card, specs = quantize_model(DictSource(state), cfg, qcfg,
                                     calib_batches=calib, device=cuda)
    return cfg, specs, card, params_to(card, "cpu")


@pytest.mark.parametrize("config", ["mix8", "mix4", "mix4_g64"])
def test_tiny_ppl_on_the_card_equals_the_cpu(cuda, config, record_property):
    """compute_perplexity on the card (kernels 1, 2 and A) against the same
    params on the CPU (the plain versions), bf16 and int8 KV: within the
    larger of the CPU's own int8-vs-bf16 KV gap and 1e-3 of its PPL (the
    limit chip_smoke.py's phase 10 holds its FP16 and W8A8 rows to; its
    trained A4 rows take 2.5e-3); the kernels counted."""
    import numpy as np

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.eval import compute_perplexity

    qcfg = {"mix8": QuantConfig.w8a8(outlier_budget=32),
            "mix4": QuantConfig.w4a4(),
            "mix4_g64": QuantConfig.w4a4(q_group_size=64)}[config]
    cfg, specs, card, cpu = _eval_model(cuda, qcfg)
    tokens = np.random.RandomState(7).randint(2, cfg.vocab_size, 8 * 128)
    before = mix_gemm.launches
    ppl = {(kv, where): compute_perplexity(p, cfg, tokens, specs, n_ctx=128,
                                           batch_size=8, kv_dtype=kv).ppl
           for kv in ("bfloat16", "int8")
           for where, p in (("card", card), ("cpu", cpu))}
    assert mix_gemm.launches - before == 2 * 2 * 7     # 2 KV x 2 layers
    gap = abs(ppl[("int8", "cpu")] - ppl[("bfloat16", "cpu")])
    for kv in ("bfloat16", "int8"):
        d = abs(ppl[(kv, "card")] - ppl[(kv, "cpu")])
        record_property(f"{kv}_diff", d)
        assert d <= max(gap, 1e-3 * ppl[(kv, "cpu")]), (kv, ppl)


def test_mmlu_and_offline_tasks_on_the_card(cuda):
    """evaluate_mmlu on the card gives the CPU's result on the same W8A8
    params; cloze and completion through MixQLM on the card score >= 0.9
    on a W8A8 Markov LM, its completion decoding through kernel 8."""
    import csv
    import os
    import tempfile

    import numpy as np

    from mixq_tpu_torch.config import ModelConfig, QuantConfig
    from mixq_tpu_torch.eval.lm_eval_adaptor import MixQLM
    from mixq_tpu_torch.eval.mmlu import evaluate_mmlu
    from mixq_tpu_torch.eval.offline_tasks import (
        IntTokenizer, build_cloze_task, build_completion_task,
        evaluate_cloze, evaluate_completion)
    from mixq_tpu_torch.quantize import quantize_model
    from mixq_tpu_torch.utils.substrate import make_markov_state
    from mixq_tpu_torch.utils.testing import DictSource

    cfg, specs, card, cpu = _eval_model(cuda, QuantConfig.w8a8())

    class Tok:
        def __call__(self, text, add_special_tokens=True):
            class R:
                input_ids = [min(ord(c), cfg.vocab_size - 1) for c in text]
            return R()

    with tempfile.TemporaryDirectory() as d:
        for split, n in (("dev", 5), ("test", 12)):
            os.makedirs(os.path.join(d, split))
            for subject in ("algebra", "biology"):
                with open(os.path.join(d, split, f"{subject}_{split}.csv"),
                          "w", newline="") as f:
                    w = csv.writer(f)
                    for i in range(n):
                        w.writerow([f"Question {i}?", "one", "two", "three",
                                    "four", "ABCD"[i % 4]])
        got = evaluate_mmlu(card, cfg, specs, Tok(), d, n_shot=2)
        want = evaluate_mmlu(cpu, cfg, specs, Tok(), d, n_shot=2)
    assert got.n_questions == want.n_questions == 24
    assert got.per_subject == want.per_subject

    mcfg = ModelConfig(model_type="llama", vocab_size=512, hidden_size=256,
                       intermediate_size=704, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=4)
    state, succ = make_markov_state(mcfg, v_eff=128, seed=0, mean_cycle=12)
    params, mspecs = quantize_model(DictSource(state), mcfg,
                                    QuantConfig.w8a8(), device=cuda)
    lm = MixQLM(params, mcfg, mspecs, IntTokenizer(), batch_size=8,
                max_length=64)
    walk = [5]
    for _ in range(400):
        walk.append(int(succ[walk[-1]]))
    corpus = np.asarray(walk, np.int32)
    res = evaluate_cloze(lm, build_cloze_task(corpus, n_items=16, ctx_len=8,
                                              cont_len=3))
    assert res["acc"] >= 0.9, res
    before = decode_attention.launches
    res = evaluate_completion(lm, build_completion_task(
        corpus, n_items=8, ctx_len=8, gen_len=3))
    assert res["exact_match"] >= 0.9, res
    assert decode_attention.launches > before


@pytest.mark.parametrize("H", [256, 3584, 4096, 5120])
def test_rmsnorm_on_the_card_equals_the_cpu(cuda, H, record_property):
    """models/layers.py::rmsnorm (the final norm before every logit, the
    W8A16 paths' norm, gemma2's post-norms) on the card against the CPU,
    at the tiny gate's, Gemma-2's, Llama-2-7B's and Baichuan-13B's widths.
    The f32 row sum runs in another order on the card, and torch.mean
    there multiplies by 1/H: every output within one bf16 ulp of the
    CPU's, and at most 1e-4 of them differing at all (the shares are
    recorded; with the sum divided by H in IEEE f32 instead they read
    about the same, so the cause is the sum's order and the norm keeps
    torch.mean)."""
    from mixq_tpu_torch.models.layers import rmsnorm

    g = torch.Generator().manual_seed(H)
    x = (torch.randn(256, H, generator=g) * 3).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(H, generator=g)
    card = rmsnorm(x.to(cuda), scale.to(cuda)).cpu()
    cpu = rmsnorm(x, scale)
    sq = x.float() ** 2
    card_sum = torch.sum(sq.to(cuda), dim=-1)
    differ = (card.view(torch.int16) != cpu.view(torch.int16)).float().mean()
    record_property("differing_share", float(differ))
    record_property("row_sums_differing_share", float(
        (card_sum.cpu() != torch.sum(sq, dim=-1)).float().mean()))
    assert ((card.float() - cpu.float()).abs()
            <= BF16_ULP * cpu.float().abs()).all()
    assert differ <= 1e-4


@pytest.mark.parametrize("config", ["w4a4_g128", "w8a16", "quik"])
def test_checkpoint_round_trip_on_the_card(cuda, config, tmp_path):
    """A small model's W4A4O16 g128 (kernel A), QUIK W4A4 (kernels 2 and A
    in their zero-point modes) or W8A16 (kernel B) params,
    saved from the card and loaded straight back onto it: the loaded params
    serve the greedy tokens of the params before the save, through the
    kernel of their mode; the same checkpoint loaded on the CPU gives the
    same params, bit for bit."""
    from mixq_tpu_torch.config import EngineConfig, ModelConfig, QuantConfig
    from mixq_tpu_torch.convert import params_to
    from mixq_tpu_torch.engine import InferenceEngine
    from mixq_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mixq_tpu_torch.models.decoder import init_decoder_params
    from mixq_tpu_torch.quantize import (load_checkpoint, resolve_specs,
                                         save_checkpoint)

    cfg = ModelConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=8, num_key_value_heads=4)
    qcfg = {"w4a4_g128": QuantConfig.w4a4(outlier_budget=16,
                                          q_group_size=128),
            "quik": QuantConfig.quik_w4a4(outlier_budget=16),
            "w8a16": QuantConfig.w8a16()}[config]
    specs = resolve_specs(qcfg)
    params = init_decoder_params(cfg, specs, _gen(17), device=cuda,
                                 dtype=torch.bfloat16, outlier_budget=16)
    ecfg = EngineConfig(max_seq_len=128, prefill_chunk=16, kv_dtype="int8")
    prompts = [[5, 17, 33, 2, 9], [101, 7, 64, 3]]
    before = InferenceEngine(params, cfg, specs, ecfg,
                             device=cuda).generate(prompts, 8)
    d = str(tmp_path / "ck")
    save_checkpoint(d, params, cfg, qcfg)
    loaded, cfg2, q2 = load_checkpoint(d, device=cuda)
    assert cfg2 == cfg and q2 == qcfg
    _assert_params_equal(loaded, load_checkpoint(d, device="cpu")[0])
    _assert_params_equal(loaded, params_to(params, "cpu"))
    reset_launch_counts()
    after = InferenceEngine(loaded, cfg2, resolve_specs(q2), ecfg,
                            device=cuda).generate(prompts, 8)
    counts = launch_counts()
    assert after == before
    mode = {"w4a4_g128": "mix_gemm.w4_grouped", "quik": "mix_gemm.w4_zp",
            "w8a16": "w8a16.w8"}[config]
    assert counts[mode] > 0, counts


def test_safetensors_reads_onto_the_card_in_its_dtype(cuda, tmp_path):
    """The reader copies a tensor straight to the card in its stored dtype
    (the card's memory grows by its bf16 bytes, no f32 copy); an HF source
    on the card widens there, and the card's tensor equals the CPU's."""
    from mixq_tpu_torch.models.hf import TensorSource, _f32
    from mixq_tpu_torch.utils.safetensors_io import SafeTensorsFile, save_file

    g = torch.Generator().manual_seed(3)
    w = (torch.randn(4096, 2048, generator=g)).to(torch.bfloat16)
    p = str(tmp_path / "model.safetensors")
    save_file({"model.w": w, "odd": torch.ones(3, dtype=torch.uint8),
               "model.b": w[:7].clone()}, p)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with SafeTensorsFile(p) as f:
        t = f.get("model.w", cuda)
        torch.cuda.synchronize()
        assert t.dtype == torch.bfloat16 and t.device.type == "cuda"
        assert torch.cuda.max_memory_allocated() - base <= w.numel() * 2
        assert torch.equal(t.cpu(), w)
        assert torch.equal(f.get("model.b", cuda).cpu(), w[:7])
    del t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    src = TensorSource.from_safetensors_dir(str(tmp_path), cuda)
    x = _f32(src, "model.w", cuda)
    assert x.dtype == torch.float32 and torch.equal(x.cpu(), w.float())
    assert torch.cuda.max_memory_allocated() - base <= w.numel() * 6
