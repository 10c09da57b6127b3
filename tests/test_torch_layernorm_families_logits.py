"""PyTorch port, the LayerNorm families and chatglm of
tests/test_torch_layernorm_families.py (falcon at g = 9, its new decoder
and its ALiBi, gptj's partial gptj-style RoPE and parallel block, opt's
learned positions and relu, starcoder2 at g = 9 with biases, chatglm at g =
16) on the CPU: teacher-forced logits against JAX's eager `forward`.

A prefill of 8 then 4 decode steps with left-padding starts: FP16 on the
batch-major bf16 cache (kernel 8's plain version at T = 1, here at g = 9
and 16 in its head tiles) and W8A8O16 with planted outlier sets on the
head-major int8 cache (kernel 3's plain version, against JAX's Pallas
flash kernel in interpret mode). Held within 5e-3 * max|logits|
(tests/test_torch_decoder.py's limit) or, on the int8 cache, within the
gap between JAX's own jitted and eager forwards on the same run if that is
larger (an exp() ulp flips a probability level of kernel 3's int8 recipe
now and then), as tests/test_torch_families_logits.py holds the RMSNorm
families.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.layers import KVCache

from test_torch_layernorm_families import (FAMILIES, build,  # noqa: F401
                                           one_thread)


_jit_forward = jax.jit(j_forward, static_argnames=("specs", "cfg"))


@pytest.mark.parametrize("precision,kv_dtype,head_major", [
    ("fp16", "bfloat16", False), ("w8a8", "int8", True)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_teacher_forced_logits_vs_jax(family, precision, kv_dtype,
                                      head_major):
    cfg, tcfg, jp, jspecs, tp, tspecs = build(family, 1, precision)
    toks = np.random.default_rng(4).integers(
        1, cfg.vocab_size, (3, 12)).astype(np.int32)
    kv_start = np.array([0, 2, 5], np.int32)
    chunks = [toks[:, :8]] + [toks[:, i:i + 1] for i in range(8, 12)]
    L, nkv, hd = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                  cfg.head_dim_)

    def jcache():
        return JKVCache.create(L, 3, 32, nkv, hd, jnp.dtype(kv_dtype),
                               head_major=head_major,
                               **({"tail_r": 0} if head_major else {}))

    jc = jcache()
    tc = KVCache.create(L, 3, 32, nkv, hd, getattr(torch, kv_dtype),
                        head_major=head_major, device="cpu")
    head = lm_head_f32(tp, tspecs)
    gap, eager = 0.0, []
    for chunk in chunks:
        jl, jc = j_forward(jp, jnp.asarray(chunk), jc, jspecs, cfg,
                           jnp.asarray(kv_start))
        tl, tc = forward(tp, torch.from_numpy(chunk), tc, tspecs, tcfg,
                         torch.from_numpy(kv_start), head_f32=head)
        jl = np.asarray(jl)
        eager.append(jl)
        assert tl.shape == jl.shape and tl.dtype == torch.float32
        gap = max(gap, np.abs(tl.numpy() - jl).max() / np.abs(jl).max())
    spread = 0.0
    if head_major and gap > 5e-3:
        # JAX's own two paths on the same run, its jitted forward against
        # its eager one (compiled only when the limit needs it)
        jc_jit = jcache()
        for chunk, jl in zip(chunks, eager):
            jj, jc_jit = _jit_forward(jp, jnp.asarray(chunk), jc_jit,
                                      specs=jspecs, cfg=cfg,
                                      kv_start=jnp.asarray(kv_start))
            spread = max(spread, np.abs(np.asarray(jj) - jl).max()
                         / np.abs(jl).max())
    assert gap <= max(5e-3, spread), (gap, spread)
    assert tc.head_major is head_major and tc.host_length == 12
