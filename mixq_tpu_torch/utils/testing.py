"""Random-model helpers for tests and the accuracy-gate scripts (mirrors
mixq_tpu/utils/testing.py). JAX's `DictSource` is the port's
`models.hf.TensorSource.from_dict`; `random_hf_state` is a copy that draws
the same numbers from the same seed."""
from __future__ import annotations

import numpy as np

from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.models.hf import TensorSource


def DictSource(d) -> TensorSource:
    """A TensorSource over a plain dict of numpy arrays or tensors."""
    return TensorSource.from_dict(d)


def random_hf_state(cfg: ModelConfig, seed: int = 0,
                    outlier_channels=(), outlier_scale: float = 60.0):
    """Random llama-style state dict in HF naming. `outlier_channels`
    multiplies those embedding channels by `outlier_scale`."""
    rng = np.random.RandomState(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    d = {"model.embed_tokens.weight":
         rng.randn(V, H).astype(np.float32) * 0.02,
         "model.norm.weight": np.ones(H, np.float32),
         "lm_head.weight": rng.randn(V, H).astype(np.float32) * 0.02}
    for ch in outlier_channels:
        d["model.embed_tokens.weight"][:, ch] *= outlier_scale
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        d[p + "input_layernorm.weight"] = np.ones(H, np.float32)
        d[p + "post_attention_layernorm.weight"] = np.ones(H, np.float32)
        d[p + "self_attn.q_proj.weight"] = (
            rng.randn(nq * hd, H).astype(np.float32) * 0.05)
        d[p + "self_attn.k_proj.weight"] = (
            rng.randn(nkv * hd, H).astype(np.float32) * 0.05)
        d[p + "self_attn.v_proj.weight"] = (
            rng.randn(nkv * hd, H).astype(np.float32) * 0.05)
        d[p + "self_attn.o_proj.weight"] = (
            rng.randn(H, nq * hd).astype(np.float32) * 0.05)
        d[p + "mlp.gate_proj.weight"] = (
            rng.randn(I, H).astype(np.float32) * 0.05)
        d[p + "mlp.up_proj.weight"] = (
            rng.randn(I, H).astype(np.float32) * 0.05)
        d[p + "mlp.down_proj.weight"] = (
            rng.randn(H, I).astype(np.float32) * 0.05)
    return d
