"""PyTorch port: the quantizers and scalers divide in IEEE f32 on every
device (`mixq_tpu_torch.utils.arith.true_div`), and on the CPU that gives the
same bits as the division by a Python number they used before.

On CUDA, PyTorch runs `x / 127.0` as a multiply by the reciprocal, which is
an ulp off now and then; JAX, the CPU and the kernels divide. The sites:
`quantize_act_per_token` (absmax / qmax, A8 and A4; kernel 1's plain
version and `prepare_act`), `quantize_kv` (absmax / 127), the three weight
quantizers, gemma2's final softcap (logits / cap), the temperature of
`sample` (logits / temperature) and RoPE's exponent (arange / dim). Each is
held here, bit for bit, against its old formula written out below with
Python-number divisions, on seeded numpy inputs."""
import numpy as np
import pytest
import torch

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.engine import sampling as S
from mixq_tpu_torch.models import decoder as D
from mixq_tpu_torch.models.layers import KVCache, rope_cos_sin
from mixq_tpu_torch.ops import quant as Q
from mixq_tpu_torch.utils.arith import true_div


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, shape).astype(np.float32)
    # a few large entries per row, as outlier channels give
    x.reshape(-1, shape[-1])[:, rng.choice(shape[-1], 3, replace=False)] *= 20
    return torch.from_numpy(x)


def _old_act(x, bits):
    qmax = 127.0 if bits == 8 else 7.0
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / qmax, 1e-8)
    return torch.clamp(torch.round(x / scale), -qmax, qmax).to(
        torch.int8), scale


def _old_kv(x):
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _old_w8(w):
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=0) / 127.0, 1e-8)
    return torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(
        torch.int8), scale


def _old_w4(w, denom):
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=0) / denom, 1e-8)
    return torch.clamp(torch.round(w / scale[None, :]), -8, 7).to(
        torch.int8), scale


def _old_grouped(w, bits, gs):
    K, N = w.shape
    qmax = 127.0 if bits == 8 else 7.0
    wg = w.float().reshape(K // gs, gs, N)
    scale = torch.clamp_min(wg.abs().amax(dim=1) / qmax, 1e-8)
    q = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax - 1, qmax)
    return q.reshape(K, N).to(torch.int8), scale


def _old_rope(positions, dim, theta):
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _equal(got, old):
    for a, b in zip(got, old):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits", [8, 4])
def test_act_per_token_bits_unchanged(bits, dtype):
    x = _normal(bits, (64, 4096), 3.0).to(dtype)
    _equal(Q.quantize_act_per_token(x, bits=bits), _old_act(x, bits))


@pytest.mark.parametrize("shape", [(4, 40, 2, 128), (3, 7, 256)])
def test_kv_bits_unchanged(shape):
    x = _normal(len(shape), shape).to(torch.bfloat16)
    _equal(Q.quantize_kv(x), _old_kv(x))


@pytest.mark.parametrize("bits,gs", [(8, 128), (4, 128), (4, 64)])
def test_weight_quantizers_bits_unchanged(bits, gs):
    w = _normal(bits + gs, (512, 384), 0.02)
    _equal(Q.quantize_weight_int8(w), _old_w8(w))
    for denom in (7.0, 6.5):
        _equal(Q.quantize_weight_int4(w, denom), _old_w4(w, denom))
    _equal(Q.quantize_weight_grouped(w, bits, gs), _old_grouped(w, bits, gs))


@pytest.mark.parametrize("dim,theta", [(128, 10000.0), (96, 10000.0),
                                       (80, 500000.0)])
def test_rope_bits_unchanged(dim, theta):
    pos = torch.from_numpy(np.random.default_rng(dim).integers(
        0, 4096, (3, 17)).astype(np.int32))
    _equal(rope_cos_sin(pos, dim, theta), _old_rope(pos, dim, theta))


def _recording(module, monkeypatch):
    """Replace `module.true_div` by one that records (x, d, result)."""
    seen = []

    def rec(x, d):
        out = true_div(x, d)
        seen.append((x, d, out))
        return out
    monkeypatch.setattr(module, "true_div", rec)
    return seen


def test_sample_temperature_bits_unchanged(monkeypatch):
    logits = _normal(7, (4, 1000), 2.0)
    params = S.SamplingParams(temperature=0.7, top_k=50, top_p=0.9)
    seen = _recording(S, monkeypatch)
    toks = S.sample(logits, torch.Generator().manual_seed(3), params)
    ((x, d, out),) = seen
    assert x is logits and d == 0.7 and torch.equal(out, logits / 0.7)
    # the same draw through the old formula
    monkeypatch.setattr(S, "true_div", lambda x, d: x / d)
    old = S.sample(logits, torch.Generator().manual_seed(3), params)
    assert torch.equal(toks, old)


def test_gemma2_final_softcap_bits_unchanged(monkeypatch):
    cfg = ModelConfig.tiny(
        model_type="gemma2", hidden_size=128, intermediate_size=256,
        num_attention_heads=4, num_key_value_heads=2, rms_norm_eps=1e-6,
        hidden_act="gelu_pytorch_tanh", gated_mlp=True,
        tie_word_embeddings=True, embed_multiplier=128 ** 0.5,
        post_norms=True, query_pre_attn_scalar=24.0, attn_logit_softcap=0.4,
        final_logit_softcap=0.6, sliding_window=64, sliding_window_pattern=2)
    specs = D.DecoderSpecs.fp16()
    params = D.init_decoder_params(cfg, specs,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    head = D.lm_head_f32(params, specs)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 6)))

    def run():
        cache = KVCache.create(cfg.num_hidden_layers, 2, 32,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               device="cpu")
        return D.forward(params, toks, cache, specs, cfg, head_f32=head)[0]

    seen = _recording(D, monkeypatch)
    got = run()
    ((x, d, out),) = seen
    assert d == 0.6 and torch.equal(out, x / 0.6)
    monkeypatch.setattr(D, "true_div", lambda x, d: x / d)
    assert torch.equal(got, run())
