"""Shared builder for the PyTorch port's model-level tests: a tiny llama
(ModelConfig.tiny at head_dim 32, GQA) from JAX's init_decoder_params,
quantized by the JAX package with planted outlier channels
(from_float(outlier_set=...)) on every MIX linear input, and the same
weights carried over to the port with convert.decoder_params_from_numpy. It
holds no tests of its own.

`build(seed)` is W8A8 on every linear; `build(seed, qcfg=...)` takes the
per-slot policy from resolve_specs(qcfg) on both sides, e.g. W4A4 (q/k/v/
up/gate packed W4A4, o/down W8A8, optionally grouped) or W8A16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mixq_tpu.config import ModelConfig, QuantConfig
from mixq_tpu.models.decoder import DecoderSpecs, init_decoder_params
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec, from_float
from mixq_tpu.quantize import resolve_specs
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.models.decoder import DecoderSpecs as TSpecs
from mixq_tpu_torch.ops.mixed_linear import LinearSpec as TLinearSpec
from mixq_tpu_torch.quantize import resolve_specs as t_resolve_specs

BUDGET, N_OUT = 16, 8
# group size of the grouped tiny models: a multiple of 16 that divides K/2
# of every tiny linear (64 and 128)
TINY_GROUP = 32
CONFIGS = {
    "w4a4": QuantConfig.w4a4(outlier_budget=BUDGET),
    "w4a4_g32": QuantConfig.w4a4(outlier_budget=BUDGET,
                                 q_group_size=TINY_GROUP),
    "w8a16": QuantConfig.w8a16(),
}


def tiny_cfg() -> ModelConfig:
    return ModelConfig.tiny(hidden_size=128, intermediate_size=256,
                            num_attention_heads=4, num_key_value_heads=2)


def build(seed: int, quantized: bool = True, qcfg: QuantConfig = None,
          cfg: ModelConfig = None):
    """(cfg, JAX params, JAX specs with attn_impl="flash", port params on
    the CPU, port specs with attn_impl="flash" too). quantized=False keeps
    the FP16 (bf16) linears; `cfg` defaults to tiny_cfg()."""
    cfg = cfg or tiny_cfg()
    rng = np.random.default_rng(seed)
    fp = init_decoder_params(jax.random.PRNGKey(seed), cfg,
                             DecoderSpecs.fp16())
    if not quantized:
        return (cfg, fp, dataclasses.replace(DecoderSpecs.fp16(),
                                             attn_impl="flash"),
                decoder_params_from_numpy(jax.tree.map(np.asarray, fp),
                                          device="cpu"),
                dataclasses.replace(TSpecs.fp16(), attn_impl="flash"))
    if qcfg is None:
        specs = DecoderSpecs.uniform(LinearSpec(w_bit=8, a_bit=8))
        tspecs = TSpecs.uniform(TLinearSpec(w_bit=8, a_bit=8))
    else:
        specs = resolve_specs(qcfg)
        tspecs = t_resolve_specs(TQuantConfig.from_dict(qcfg.to_dict()))

    def oset(K, spec):
        if spec.version != "MIX":
            return None
        return JQ.outlier_set_from_indices(
            np.sort(rng.choice(K, N_OUT, replace=False)), K, BUDGET)

    def q(p, spec, os_):
        return from_float(p.q_weight.astype(jnp.float32), spec,
                          outlier_set=os_)

    blocks = []
    for bp in fp.blocks:
        a, m = bp.attn, bp.mlp
        s_qkv = oset(a.wq.q_weight.shape[0], specs.wqkv)
        s_up = oset(m.up.q_weight.shape[0], specs.up)
        blocks.append(bp._replace(
            attn=a._replace(
                wq=q(a.wq, specs.wqkv, s_qkv), wk=q(a.wk, specs.wqkv, s_qkv),
                wv=q(a.wv, specs.wqkv, s_qkv),
                wo=q(a.wo, specs.wo,
                     oset(a.wo.q_weight.shape[0], specs.wo))),
            mlp=m._replace(
                up=q(m.up, specs.up, s_up), gate=q(m.gate, specs.gate, s_up),
                down=q(m.down, specs.down,
                       oset(m.down.q_weight.shape[0], specs.down)))))
    jparams = fp._replace(blocks=tuple(blocks))
    tparams = decoder_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    return (cfg, jparams, dataclasses.replace(specs, attn_impl="flash"),
            tparams, dataclasses.replace(tspecs, attn_impl="flash"))
