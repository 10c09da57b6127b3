"""PyTorch port: forward(collect_stats=...) against JAX's eager `forward`
on the tiny models of tests/test_torch_models.py (W8A8 with planted outlier
channels, FP16 linears, and W4A4), a prefill chunk and a decode step on
the batch-major bf16 cache, as calibration and warmup run it.

- True: {"{layer}.{wqkv|wo|up|down}": [K] f32} per-channel absmax over
  batch and time of each linear group's input (the normed x, which on a
  MIX path is kernel 1's y; the attention output; the normed MLP input;
  the inner product of gate and up). Held within 1e-2 of max|stat| per
  key: every stat is a max of bf16 values, and what differs between the
  two forwards is f32 summation order (decoder tests), which can flip one
  bf16 rounding (2**-8 relative) of an activation upstream. (On this
  test's inputs the two read bit-equal.)
- "full": the raw inputs, whose channel absmax is the True statistic.
- Off: the forward returns (logits, cache), and its logits are those of
  the stats forward bit for bit."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.ops.quant import absmax_channels

import test_torch_models as models

STAT_TOL = 1e-2
SLOTS = ("wqkv", "wo", "up", "down")


def caches(cfg, B, S):
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)
    return (JKVCache.create(L, B, S, nkv, hd, jnp.bfloat16),
            KVCache.create(L, B, S, nkv, hd, torch.bfloat16, device="cpu"))


def run_both(config, quantized, collect):
    cfg, jp, jspecs, tp, tspecs = models.build(
        seed=1, quantized=quantized, qcfg=models.CONFIGS.get(config))
    jspecs = dataclasses.replace(jspecs, attn_impl="xla")
    tspecs = dataclasses.replace(tspecs, attn_impl="xla")
    B, T = 3, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    jc, tc = caches(cfg, B, 16)
    head = lm_head_f32(tp, tspecs)
    out = []
    for chunk in (toks[:, :T], toks[:, T:]):
        _, jc, js = j_forward(jp, jnp.asarray(chunk), jc, jspecs, cfg,
                              collect_stats=collect)
        _, tc, ts = forward(tp, torch.from_numpy(chunk), tc, tspecs, cfg,
                            head_f32=head, collect_stats=collect)
        out.append((js, ts))
    return cfg, out


@pytest.mark.parametrize("config,quantized", [(None, True), (None, False),
                                              ("w4a4", True)])
def test_stats_as_jax_eager(config, quantized):
    cfg, out = run_both(config, quantized, True)
    for js, ts in out:
        keys = {f"{i}.{s}" for i in range(cfg.num_hidden_layers)
                for s in SLOTS}
        assert set(ts) == set(js) == keys
        for k in keys:
            j = np.asarray(js[k])
            assert ts[k].dtype == torch.float32 and ts[k].shape == j.shape
            np.testing.assert_allclose(ts[k].numpy(), j, rtol=0,
                                       atol=STAT_TOL * np.abs(j).max(),
                                       err_msg=k)
    K = {"wqkv": cfg.hidden_size, "up": cfg.hidden_size,
         "wo": cfg.num_attention_heads * cfg.head_dim_,
         "down": cfg.intermediate_size}
    assert all(out[0][1][f"0.{s}"].shape == (K[s],) for s in SLOTS)


def test_full_stats_are_the_raw_inputs():
    cfg, out = run_both(None, True, "full")
    _, full = out[0]
    cfg, out = run_both(None, True, True)
    _, absmax = out[0]
    for k, x in full.items():
        assert x.shape[:2] == (3, 8) and x.dtype == torch.bfloat16
        assert torch.equal(absmax_channels(x), absmax[k])


def test_stats_off_leaves_the_forward_as_it_was():
    cfg, jp, jspecs, tp, tspecs = models.build(seed=2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 6)).astype(np.int32))
    head = lm_head_f32(tp, tspecs)
    got = []
    for collect in (False, True):
        _, tc = caches(cfg, 2, 8)
        res = forward(tp, toks, tc, tspecs, cfg, head_f32=head,
                      collect_stats=collect)
        assert len(res) == (3 if collect else 2)
        got.append(res[0])
    assert torch.equal(got[0], got[1])
