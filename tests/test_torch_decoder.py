"""PyTorch port: teacher-forced prefill + 4 decode steps of the tiny W8A8
model with planted outliers against JAX `forward` (attn_impl="flash" on a
head-major cache with no tail window), bf16 and int8 KV, of the same model
with FP16 linears, and of the tiny models of resolve_specs(W4A4) (packed
W4A4 q/k/v/up/gate, W8A8 o/down), per-channel and grouped, and of
resolve_specs(W8A16). The same tokens feed both sides at every step, so one
rounding flip cannot cascade. A last test shows the routing rule: only MIX
linears take the fused norm + quantization (kernel 1), so a W8A16 model
calls it never.

Tolerances: logits within 5e-3 * max|logits| — the int linears,
quantization and KV writes are bit-equal, and what differs is f32
summation order (norm mean, outlier dot, the grouped scale sum, the W8A16
bf16 dot, attention, exp), which can flip one bf16 rounding of an
activation (2**-8 relative; a 4-bit activation level is 1/7 of the row's
absmax, but a flip across a level boundary is as rare as for int8 and is
covered by the same limit) that then propagates; the dequantized KV
contents within 1e-2 * max|k| (one such flip moves a value by at most one
int8 level or one bf16 ulp)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu_torch.models import layers as t_layers
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

import test_torch_models as models

STEPS = 4


def _dequant(k, s):
    k = np.asarray(k, np.float32)
    if s is None:
        return k
    return k * np.asarray(s, np.float32)[..., :k.shape[-2], None]


@pytest.mark.parametrize("kv_dtype,quantized,config", [
    ("bfloat16", True, None), ("int8", True, None), ("bfloat16", False, None),
    ("bfloat16", True, "w4a4"), ("int8", True, "w4a4"),
    ("int8", True, "w4a4_g32"), ("bfloat16", True, "w8a16"),
    ("int8", True, "w8a16")])
def test_teacher_forced_logits_and_cache(kv_dtype, quantized, config):
    cfg, jp, jspecs, tp, tspecs = models.build(
        seed=1, quantized=quantized, qcfg=models.CONFIGS.get(config))
    B, T, S = 3, 8, 32
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab_size, (B, T + STEPS)).astype(np.int32)
    kv_start = np.array([0, 3, 5], np.int32)
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    jc = JKVCache.create(L, B, S, nkv, hd, jnp.dtype(kv_dtype),
                         head_major=True, tail_r=0)
    tc = KVCache.create(L, B, S, nkv, hd, getattr(torch, kv_dtype),
                        head_major=True, device="cpu")
    chunks = [toks[:, :T]] + [toks[:, T + i:T + i + 1] for i in range(STEPS)]
    head = lm_head_f32(tp, tspecs)
    for chunk in chunks:
        jl, jc = j_forward(jp, jnp.asarray(chunk), jc, jspecs, cfg,
                           jnp.asarray(kv_start))
        tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, cfg,
                         torch.from_numpy(kv_start), head_f32=head)
        jl = np.asarray(jl)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())
    assert tc.length == int(jc.length) == T + STEPS
    for jbuf, jsc, tbuf, tsc in ((jc.k, jc.k_scale, tc.k, tc.k_scale),
                                 (jc.v, jc.v_scale, tc.v, tc.v_scale)):
        jd = _dequant(jbuf, jsc)[:, :, :, :T + STEPS]
        td = _dequant(tbuf.float(), None if tsc is None else tsc)
        td = td[:, :, :, :T + STEPS]
        np.testing.assert_allclose(td, jd, rtol=0,
                                   atol=1e-2 * np.abs(jd).max())


@pytest.mark.parametrize("config,norm_quant_calls", [
    ("w8a16", 0), ("w4a4", 2), ("w4a4_g32", 2)])
def test_only_mix_linears_share_a_prepared_act(monkeypatch, config,
                                               norm_quant_calls):
    """Per layer and forward: a W8A16 model never calls the fused norm +
    quantization (its linears take the plain rmsnorm output, as in JAX);
    W4A4 calls it twice (q/k/v, up/gate), and o/down prepare their own."""
    cfg, _, _, tp, tspecs = models.build(seed=1, qcfg=models.CONFIGS[config])
    calls = []
    real = t_layers.fused_rmsnorm_quant

    def counting(*a, **kw):
        calls.append(kw.get("a_bits"))
        return real(*a, **kw)

    monkeypatch.setattr(t_layers, "fused_rmsnorm_quant", counting)
    L = cfg.num_hidden_layers
    tc = KVCache.create(L, 2, 16, cfg.num_key_value_heads, cfg.head_dim_,
                        torch.int8, head_major=True, device="cpu")
    logits, _ = forward(tp, torch.ones((2, 5), dtype=torch.int64), tc,
                        tspecs, cfg, head_f32=lm_head_f32(tp, tspecs))
    assert bool(torch.isfinite(logits).all())
    assert len(calls) == norm_quant_calls * L
    assert all(bits == 4 for bits in calls)          # A4 for q/k/v, up/gate
    if config == "w8a16":
        assert all(p.out_ind is None and p.w_outlier is None
                   for b in tp.blocks for p in (*b.attn[:4], *b.mlp[:3]))


@pytest.mark.parametrize("config", ["w4a4", "w4a4_g32"])
def test_convert_carries_w4_params_bit_for_bit(config):
    """decoder_params_from_numpy of a JAX W4A4 model: every tensor of the
    port's params has JAX's dtype, shape and bits (packed uint8 [K/2, N]
    q/k/v/up/gate, int8 o/down, [G, N] scales when grouped)."""
    import jax

    _, jp, _, tp, _ = models.build(seed=3, qcfg=models.CONFIGS[config])
    jl = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    tl = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [str(p) for p, _ in jl] == [str(p) for p, _ in tl]
    for (_, a), (path, b) in zip(jl, tl):
        assert a.shape == tuple(b.shape), path
        if b.dtype == torch.bfloat16:
            assert a.dtype.name == "bfloat16", path
            np.testing.assert_array_equal(a.astype(np.float32),
                                          b.float().numpy())
        else:
            assert a.dtype == b.numpy().dtype, path
            np.testing.assert_array_equal(a, b.numpy())
    wq, wo = tp.blocks[0].attn.wq, tp.blocks[0].attn.wo
    K = wq.k_mask.shape[0]
    assert wq.q_weight.dtype == torch.uint8 and wq.q_weight.shape[0] == K // 2
    assert wo.q_weight.dtype == torch.int8
    if config == "w4a4_g32":
        assert wq.w_scale.shape == (K // models.TINY_GROUP,
                                    wq.q_weight.shape[1])


@pytest.mark.parametrize("config,spread", [(None, (0, 2e-2)),
                                           ("w4a4", (2e-2, 1e-1))])
def test_w4a4_limit_is_jax_own_spread(config, spread):
    """The JAX package's own two paths, jitted and eager `forward`, on the
    same tiny model and tokens: XLA may keep in f32 under jit what the eager
    path rounds to bf16. With W8A8 they differ by less than 2e-2 *
    max|logits| (chip_smoke.py's card-vs-CPU limit for W8A8); with 4-bit
    activations, where such a flip moves a whole level (1/7 of the row's
    absmax), by more than that but less than 1e-1, the W4A4 limit."""
    import jax

    cfg, jp, jspecs, _, _ = models.build(seed=1,
                                         qcfg=models.CONFIGS.get(config))
    B, T, S = 3, 8, 32
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size,
                                             (B, T + STEPS)).astype(np.int32)
    kv_start = jnp.asarray(np.array([0, 3, 5], np.int32))
    outs = []
    for fwd in (j_forward, jax.jit(j_forward, static_argnums=(3, 4))):
        c = JKVCache.create(cfg.num_hidden_layers, B, S,
                            cfg.num_key_value_heads, cfg.head_dim_,
                            jnp.bfloat16, head_major=True, tail_r=0)
        logits = []
        for chunk in [toks[:, :T]] + [toks[:, T + i:T + i + 1]
                                      for i in range(STEPS)]:
            lg, c = fwd(jp, jnp.asarray(chunk), c, jspecs, cfg, kv_start)
            logits.append(np.asarray(lg).reshape(-1))
        outs.append(np.concatenate(logits))
    gap = np.abs(outs[0] - outs[1]).max() / np.abs(outs[0]).max()
    assert spread[0] <= gap < spread[1], gap
