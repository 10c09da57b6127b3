"""Carry a JAX-side DecoderParams over to the port.

`decoder_params_from_numpy(params, device)` takes the JAX package's
`DecoderParams` after `jax.tree.map(np.asarray, params)` (NamedTuples of
numpy arrays, bf16 as ml_dtypes' bfloat16) and builds the port's
`DecoderParams` with the same field layout and dtypes: int8 q_weight (or
packed int4 uint8 [K/2, N], halves layout), f32 w_scale [N] or [G, N],
f32 k_mask / out_mask, bf16 w_outlier, int32 out_ind, QUIK's f32
reduced_w, embed and lm_head (None = tied). Every array is carried bit for
bit. It reads fields by name
and imports nothing of JAX. jnp.int4 weight storage is not carried: the
port keeps int4 weights packed, JAX's default storage.
"""
from __future__ import annotations

import numpy as np
import torch

from mixq_tpu_torch.models.decoder import (AttnParams, BlockParams,
                                           DecoderParams, MLPParams)
from mixq_tpu_torch.ops.mixed_linear import MixLinearParams


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) -> torch tensor on `device`."""
    a = np.asarray(a)
    if a.dtype.name == "int4":
        raise NotImplementedError(
            "jnp.int4 weight storage: quantize with packed uint8 storage")
    # np.ascontiguousarray makes a 0-d array 1-d; keep the shape
    a = np.ascontiguousarray(a).reshape(a.shape)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _opt(a, device):
    return None if a is None else tensor_from_numpy(a, device)


def _linear(p, device) -> MixLinearParams:
    if p is None:
        return None
    return MixLinearParams(**{f: _opt(getattr(p, f), device)
                              for f in MixLinearParams._fields})


def decoder_params_from_numpy(params, device="cuda") -> DecoderParams:
    """The port's DecoderParams from a numpy-mapped JAX DecoderParams."""
    if getattr(params, "stacked", None) is not None:
        raise NotImplementedError("stacked (scan) params: unstack first")
    blocks = []
    for bp in params.blocks:
        a, m = bp.attn, bp.mlp
        if getattr(m, "moe", None) is not None:
            raise NotImplementedError("MoE blocks are not ported")
        blocks.append(BlockParams(
            ln1_scale=_opt(bp.ln1_scale, device),
            ln1_bias=_opt(bp.ln1_bias, device),
            attn=AttnParams(wq=_linear(a.wq, device),
                            wk=_linear(a.wk, device),
                            wv=_linear(a.wv, device),
                            wo=_linear(a.wo, device),
                            q_norm=_opt(a.q_norm, device),
                            k_norm=_opt(a.k_norm, device)),
            ln2_scale=_opt(bp.ln2_scale, device),
            ln2_bias=_opt(bp.ln2_bias, device),
            mlp=MLPParams(up=_linear(m.up, device),
                          gate=_linear(m.gate, device),
                          down=_linear(m.down, device)),
            post_attn_norm_scale=_opt(bp.post_attn_norm_scale, device),
            post_ffw_norm_scale=_opt(bp.post_ffw_norm_scale, device),
        ))
    return DecoderParams(
        embed=tensor_from_numpy(params.embed, device),
        blocks=tuple(blocks),
        lnf_scale=_opt(params.lnf_scale, device),
        lnf_bias=_opt(params.lnf_bias, device),
        lm_head=_opt(params.lm_head, device),
        pos_embed=_opt(getattr(params, "pos_embed", None), device),
    )


def params_to(obj, device):
    """Copy a parameter container (NamedTuples / tuples of tensors) to
    another device."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(params_to(x, device) for x in obj))
    if isinstance(obj, tuple):
        return tuple(params_to(x, device) for x in obj)
    raise TypeError(f"unexpected parameter leaf {type(obj)}")
