"""PyTorch port: the plain attention references divide in IEEE f32 on every
device (`mixq_tpu_torch.utils.arith.true_div`), and on the CPU that gives
the same bits as the scalar division they used before.

On CUDA, PyTorch runs `x / 127.0` (a division by a Python number) as a
multiply by the reciprocal; the CUDA kernels, the Pallas kernels and the CPU
divide. Kernel 3's plain version divides by 127 twice (q's and p's absmax
scales) and by the softcap, and `attend`, kernel 8's plain version, by the
softcap. Each is held here, bit for bit, against the formula it had before,
written out below with Python-number divisions, int8 and bf16 KV, with and
without the softcap."""
import numpy as np
import pytest
import torch

from mixq_tpu_torch.kernels.decode_attention import decode_attention_plain
from mixq_tpu_torch.kernels.flash_decode import (MASK_VALUE,
                                                 flash_decode_level,
                                                 flash_decode_plain)
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.utils.arith import true_div


def _old_flash_parts(q, k, v, lengths, k_scale, v_scale, kv_start, softcap,
                     scale):
    """kernel 3's plain scores and softmax numerator with scalar divisions
    (one layer, [n_kv, B, S, D] cache, [B] lengths and starts)."""
    B, n_q, D = q.shape
    n_kv, _, S, _ = k.shape
    g = n_q // n_kv
    lengths = lengths.clamp(max=S)
    starts = kv_start.clamp(min=0)
    pos = torch.arange(S)
    valid = (pos[None] < lengths[:, None]) & (pos[None] >= starts[:, None])
    live = (lengths > starts).float()[:, None, None, None]
    qf = q.float().reshape(B, n_kv, g, D)
    kt = k.permute(1, 0, 3, 2)
    if k_scale is not None:
        q_scale = torch.clamp_min(qf.abs().amax(-1, keepdim=True) / 127.0,
                                  1e-8)
        q_i8 = torch.clamp(torch.round(qf / q_scale), -127, 127)
        acc = torch.matmul(q_i8.double(), kt.double()).float()
        ks = k_scale[..., :S].permute(1, 0, 2)[:, :, None, :]
        qk = acc * q_scale * ks * scale
    else:
        qk = torch.matmul(qf, kt.float()) * scale
    if softcap:
        qk = torch.tanh(qk / softcap) * softcap
    qk = torch.where(valid[:, None, None, :], qk, MASK_VALUE)
    m = qk.amax(-1, keepdim=True)
    p = torch.exp(qk - m)
    return p, p.sum(-1, keepdim=True), live


def _old_flash(q, k, v, lengths, k_scale, v_scale, kv_start, softcap,
               scale):
    p, l, live = _old_flash_parts(q, k, v, lengths, k_scale, v_scale,
                                  kv_start, softcap, scale)
    B, n_q, D = q.shape
    S = v.shape[2]
    vv = v.permute(1, 0, 2, 3)
    if k_scale is not None:
        vs = v_scale[..., :S].permute(1, 0, 2)[:, :, None, :]
        p2 = p * vs
        p_scale = torch.clamp_min(p2.amax(-1, keepdim=True) / 127.0, 1e-20)
        p_i8 = torch.round(p2 / p_scale)
        pv = torch.matmul(p_i8.double(), vv.double()).float() * p_scale
    else:
        pv = torch.matmul(p.to(torch.bfloat16).float(), vv.float())
    return (pv / l * live).reshape(B, n_q, D).to(q.dtype)


def _old_attend_t1(q, k, v, lens, starts, k_scale, v_scale, scale, softcap):
    """`attend` over a batch-major cache for the query at lens - 1, as it
    was: the softcap as scores / softcap."""
    B, n_q, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    qf = q[:, None].float().reshape(B, 1, n_kv, n_q // n_kv, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    q_pos = (lens - 1)[:, None, None]
    kv_pos = torch.arange(S)[None, None, :]
    mask = ((kv_pos <= q_pos) & (kv_pos < lens.reshape(-1, 1, 1))
            & (kv_pos >= starts[:, None, None]))
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(B, 1, n_q, D).to(q.dtype)[:, 0]


def _case(int8, seed, head_major):
    rng = np.random.default_rng(seed)
    B, S, n_q, n_kv, D = 4, 96, 8, 2, 64
    q = torch.from_numpy(rng.normal(0, 3, (B, n_q, D)).astype(
        np.float32)).to(torch.bfloat16)
    shape = (n_kv, B, S, D) if head_major else (B, S, n_kv, D)
    kf = torch.from_numpy(rng.normal(0.5, 1, shape).astype(np.float32))
    vf = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    if int8:
        (k, ks), (v, vs) = Q.quantize_kv(kf), Q.quantize_kv(vf)
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
    lens = torch.tensor([S, 50, 1, 77], dtype=torch.int32)
    starts = torch.tensor([0, 7, 0, 30], dtype=torch.int32)
    return q, k, v, ks, vs, lens, starts


def test_true_div_is_the_cpu_scalar_division():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 100, 100_000).astype(np.float32))
    for d in (127.0, 50.0, 30.0, 3.0):
        assert torch.equal(true_div(x, d), x / d)
    # a multiply by the reciprocal is not the same function
    assert not torch.equal(x / 127.0, x * (1 / 127.0))


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("int8", [True, False])
def test_flash_plain_bits_unchanged(int8, softcap):
    q, k, v, ks, vs, lens, starts = _case(int8, 3 + int8, head_major=True)
    scale = 24.0 ** -0.5
    got = flash_decode_plain(q, k, v, lens, ks, vs, starts, softcap=softcap,
                             scale=scale)
    old = _old_flash(q, k, v, lens, ks, vs, starts, softcap, scale)
    assert torch.equal(got, old)
    # the level (one flipped probability level) comes from the same parts
    p, l, _ = _old_flash_parts(q, k, v, lens, ks, vs, starts, softcap, scale)
    level = flash_decode_level(q, k, v, lens, ks, vs, starts,
                               softcap=softcap, scale=scale)
    assert level.shape == (q.shape[0], q.shape[1])
    assert bool(torch.isfinite(level).all()) and l.min() >= 1


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("int8", [True, False])
def test_decode_plain_bits_unchanged(int8, softcap):
    q, k, v, ks, vs, lens, starts = _case(int8, 5 + int8, head_major=False)
    scale = 0.0625
    got = decode_attention_plain(q, k, v, lens, ks, vs, starts, scale=scale,
                                 softcap=softcap)
    old = _old_attend_t1(q, k, v, lens.long(), starts, ks, vs, scale,
                         softcap or None)
    assert torch.equal(got, old)


def test_constant_made_in_inference_mode_serves_autograd():
    """A divisor cached by an inference-mode call (serving) is saved by a
    later division under autograd (training)."""
    from mixq_tpu_torch.utils.arith import constant

    constant.cache_clear()
    x = torch.randn(4, 96)
    with torch.inference_mode():
        true_div(x, 96)
    x.requires_grad_(True)
    (true_div(x, 96) ** 2).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
