"""Quantized checkpoints on disk (mirrors mixq_tpu/quantize/checkpoint.py),
in the JAX package's layout, so that either package loads the other's:

  <dir>/model-0000N.safetensors   flat param leaves (bf16 stored as U16)
  <dir>/manifest.json             {"format_version": 1,
                                   "weights": {path: {"shard", "dtype"}}}
  <dir>/quant_config.json         QuantConfig
  <dir>/model_config.json         ModelConfig

Leaf paths are JAX's `tree_flatten_with_path` names: NamedTuple fields
joined by ".", block indices, None leaves skipped (`blocks.3.attn.wq.
w_outlier`). The dtype tag is `str(np.dtype)` of the leaf ("int8",
"uint8", "int32", "float32"), except bf16, which is stored as U16 bits and
tagged "bfloat16" as JAX does. The port's packed W4 is a plain uint8
[K/2, N] leaf (JAX's default storage); JAX's "int4_packed" / "int4_raw"
tags come from jnp.int4 storage, which the port does not carry, and raise.

    save_checkpoint(dir, params, model_cfg, quant_cfg)
    params, model_cfg, quant_cfg = load_checkpoint(dir, device="cuda")

Shards are written one tensor at a time from wherever the params lie and
read through the port's own safetensors reader, one tensor at a time,
straight onto `device` (in place of JAX's `shardings=`, which comes with
parallelism, ROADMAP Queue A item 9).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from mixq_tpu_torch.config import ModelConfig, QuantConfig
from mixq_tpu_torch.models.decoder import (AttnParams, BlockParams,
                                           DecoderParams, MLPParams)
from mixq_tpu_torch.ops.mixed_linear import MixLinearParams
from mixq_tpu_torch.utils.safetensors_io import SafeTensorsFile, save_file

_SHARD_BYTES = 8 * 1024 ** 3        # JAX's 8 GB shards

_BF16_TAG = "bfloat16"
# the manifest's dtype tags (numpy's dtype names) of the other leaves
_TAGS = {torch.int8: "int8", torch.uint8: "uint8", torch.int32: "int32",
         torch.float32: "float32"}
_DTYPE_OF = {v: k for k, v in _TAGS.items()}
_INT4 = ("int4_packed", "int4_raw")


def _leaf_paths(params: DecoderParams) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, leaf) in JAX's flattening order, None leaves
    skipped."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(obj, path):
        if obj is None:
            return
        if isinstance(obj, torch.Tensor):
            out.append((path, obj))
        elif isinstance(obj, tuple):
            names = getattr(obj, "_fields", None) or range(len(obj))
            for k in names:
                walk(getattr(obj, k) if isinstance(k, str) else obj[k],
                     f"{path}.{k}" if path else str(k))
        else:
            raise TypeError(f"unexpected parameter leaf at {path}: "
                            f"{type(obj)}")

    walk(params, "")
    return out


def save_checkpoint(path: str, params: DecoderParams, model_cfg: ModelConfig,
                    quant_cfg: QuantConfig) -> int:
    """Write `params` as JAX's save_checkpoint does; returns the bytes of
    the shards written."""
    if params.stacked is not None:
        raise NotImplementedError(
            "stacked (scan) params are not ported (ROADMAP Queue A item 6)")
    if model_cfg.num_local_experts > 0 or any(
            bp.mlp.moe is not None for bp in params.blocks):
        raise NotImplementedError(
            "MoE blocks are not ported (ROADMAP Queue A item 7)")
    os.makedirs(path, exist_ok=True)
    manifest: Dict[str, Any] = {"format_version": 1, "weights": {}}
    shards: List[Dict[str, torch.Tensor]] = [{}]
    shard_sizes = [0]
    for name, leaf in _leaf_paths(params):
        if leaf.dtype == torch.bfloat16:
            arr, tag = leaf.view(torch.uint16), _BF16_TAG
        elif leaf.dtype in _TAGS:
            arr, tag = leaf, _TAGS[leaf.dtype]
        else:
            raise ValueError(f"{name}: dtype {leaf.dtype} has no checkpoint "
                             "tag")
        nbytes = arr.numel() * arr.element_size()
        if shard_sizes[-1] + nbytes > _SHARD_BYTES and shards[-1]:
            shards.append({})
            shard_sizes.append(0)
        shards[-1][name] = arr
        shard_sizes[-1] += nbytes
        manifest["weights"][name] = {"shard": len(shards) - 1, "dtype": tag}

    written = 0
    for i, shard in enumerate(shards):
        written += save_file(shard, os.path.join(
            path, f"model-{i:05d}.safetensors"))
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(path, "quant_config.json"), "w") as f:
        json.dump(quant_cfg.to_dict(), f, indent=2)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(model_cfg.to_dict(), f, indent=2)
    return written


class _CheckpointReader:
    """The manifest and the shards, each mapped at its first read."""

    def __init__(self, path: str, device):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.path = path
        self.device = device
        self.handles: Dict[int, SafeTensorsFile] = {}

    def names(self):
        return self.manifest["weights"].keys()

    def get(self, name: str) -> Optional[torch.Tensor]:
        meta = self.manifest["weights"].get(name)
        if meta is None:
            return None
        tag = meta["dtype"]
        if tag in _INT4:
            raise NotImplementedError(
                f"{name}: jnp.int4 weight storage ({tag}): quantize with "
                "packed uint8 storage")
        i = meta["shard"]
        if i not in self.handles:
            self.handles[i] = SafeTensorsFile(os.path.join(
                self.path, f"model-{i:05d}.safetensors"))
        t = self.handles[i].get(name, self.device)
        want = torch.uint16 if tag == _BF16_TAG else _DTYPE_OF.get(tag)
        if t.dtype != want:
            raise ValueError(f"{name}: stored {t.dtype}, manifest says "
                             f"{tag!r}")
        return t.view(torch.bfloat16) if tag == _BF16_TAG else t

    def close(self) -> None:
        for h in self.handles.values():
            h.close()


def _load_mlp(p: str, model_cfg: ModelConfig, linear) -> MLPParams:
    """The dense MLP (JAX's MoE branch is ROADMAP Queue A item 7)."""
    if model_cfg.num_local_experts > 0:
        raise NotImplementedError(
            "MoE checkpoints are not ported (ROADMAP Queue A item 7)")
    return MLPParams(
        up=linear(p + ".mlp.up"),
        gate=linear(p + ".mlp.gate", required=False),  # no-gate archs
        down=linear(p + ".mlp.down"),
    )


def load_checkpoint(path: str, device="cuda"
                    ) -> Tuple[DecoderParams, ModelConfig, QuantConfig]:
    """Rebuild the DecoderParams from a checkpoint directory (the port's
    or JAX's), each tensor read onto `device`."""
    with open(os.path.join(path, "model_config.json")) as f:
        model_cfg = ModelConfig.from_dict(json.load(f))
    with open(os.path.join(path, "quant_config.json")) as f:
        quant_cfg = QuantConfig.from_dict(json.load(f))
    reader = _CheckpointReader(path, device)
    if any(n.startswith("stacked.") for n in reader.names()):
        raise NotImplementedError(
            "stacked (scan) params are not ported (ROADMAP Queue A item 6)")
    get = reader.get

    def linear(prefix: str, required: bool = True
               ) -> Optional[MixLinearParams]:
        q = get(prefix + ".q_weight")
        if q is None:
            if required:
                raise KeyError(
                    f"checkpoint at {path} is missing required tensor "
                    f"'{prefix}.q_weight' (available prefixes: "
                    f"{sorted(set(n.split('.')[0] for n in reader.names()))})")
            return None
        return MixLinearParams(
            q_weight=q,
            w_scale=get(prefix + ".w_scale"),
            w_outlier=get(prefix + ".w_outlier"),
            out_ind=get(prefix + ".out_ind"),
            out_mask=get(prefix + ".out_mask"),
            k_mask=get(prefix + ".k_mask"),
            out_count=get(prefix + ".out_count"),
            bias=get(prefix + ".bias"),
            reduced_w=get(prefix + ".reduced_w"),
        )

    try:
        blocks = []
        for i in range(model_cfg.num_hidden_layers):
            p = f"blocks.{i}"
            blocks.append(BlockParams(
                ln1_scale=get(p + ".ln1_scale"),
                ln1_bias=get(p + ".ln1_bias"),
                attn=AttnParams(
                    wq=linear(p + ".attn.wq"),
                    wk=linear(p + ".attn.wk"),
                    wv=linear(p + ".attn.wv"),
                    wo=linear(p + ".attn.wo"),
                    q_norm=get(p + ".attn.q_norm"),
                    k_norm=get(p + ".attn.k_norm"),
                ),
                ln2_scale=get(p + ".ln2_scale"),
                ln2_bias=get(p + ".ln2_bias"),
                mlp=_load_mlp(p, model_cfg, linear),
                post_attn_norm_scale=get(p + ".post_attn_norm_scale"),
                post_ffw_norm_scale=get(p + ".post_ffw_norm_scale"),
            ))
        embed = get("embed")
        if embed is None:
            raise KeyError(f"checkpoint at {path} is missing required "
                           "'embed'")
        params = DecoderParams(
            embed=embed,
            blocks=tuple(blocks),
            lnf_scale=get("lnf_scale"),
            lnf_bias=get("lnf_bias"),
            lm_head=get("lm_head"),
            pos_embed=get("pos_embed"),
        )
    finally:
        reader.close()
    return params, model_cfg, quant_cfg
