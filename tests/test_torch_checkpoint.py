"""PyTorch port: quantize/checkpoint.py against mixq_tpu/quantize/
checkpoint.py, on tiny models built by the JAX package and carried over
with convert.decoder_params_from_numpy (tests/test_torch_models.py).

- Leaf names: the port's `_leaf_paths` equal JAX's for llama W8A8O16,
  W4A4O16 with 128-row groups, W8A16, FP16 specs, gemma2 (post-norms),
  baichuan and a W8A8 mixtral (the MoE leaves under `mlp.moe`).
- Port save -> port load: every tensor bit-equal, and the logits equal.
- JAX save_checkpoint -> port load_checkpoint: bit-equal to
  decoder_params_from_numpy of the same JAX params, and the port's greedy
  tokens equal JAX's (W8A8O16, W4A4O16 g128, W8A16; each step's top-2
  margin asserted above 5e-3 * max|logits|). JAX's jitted engine leaves its
  own eager path on the tiny W4A4 models (ROADMAP Queue C), so the W4A4
  tokens come from JAX's engine under jax.disable_jit().
- Port save_checkpoint -> JAX load_checkpoint: bit-equal, and JAX's logits
  on the loaded params equal its logits on the originals.
- The same params written by both packages give equal manifests (names,
  shards, dtype tags) and configs, with _SHARD_BYTES patched small on both
  sides so that the checkpoint spans several shards.
- MoE params round-trip bit-equal; stacked params raise
  (NotImplementedError citing ROADMAP item 6).
- Errors: a missing tensor (KeyError naming it), JAX's int4_packed tag,
  and the card as the default device on a machine without one."""
import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import ModelConfig, QuantConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import DecoderSpecs as JSpecs
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu.models.decoder import init_decoder_params as j_init
from mixq_tpu.ops.mixed_linear import LinearSpec as JLinearSpec
from mixq_tpu.quantize import checkpoint as jck
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.config import ModelConfig as TModelConfig
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.models.decoder import DecoderSpecs as TSpecs
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.ops.mixed_linear import LinearSpec as TLinearSpec
from mixq_tpu_torch.models.layers import KVCache
from mixq_tpu_torch.quantize import checkpoint as tck

import test_torch_baichuan as baichuan
import test_torch_gemma2 as gemma2
import test_torch_models as models

BUDGET = models.BUDGET
# 128-row groups need K/2 >= 128 on every grouped linear
WIDE = ModelConfig.tiny(hidden_size=256, intermediate_size=512,
                        num_attention_heads=8, num_key_value_heads=4)
# name -> (QuantConfig, cfg or None for models.tiny_cfg(), seed)
CASES = {
    "w8a8o16": (QuantConfig.w8a8(outlier_budget=BUDGET), None, 1),
    "w4a4o16_g128": (QuantConfig.w4a4(outlier_budget=BUDGET,
                                      q_group_size=128), WIDE, 9),
    "w8a16": (QuantConfig.w8a16(), None, 1),
}
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread (tests/test_torch_substrate.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(case):
    """(cfg, JAX params, JAX specs, port params, port specs, QuantConfig):
    models.build with the case's per-slot policy (W8A8O16: W8A8 on every
    linear)."""
    qcfg, cfg, seed = CASES[case]
    cfg_, jp, jspecs, tp, tspecs = models.build(
        seed, qcfg=None if case == "w8a8o16" else qcfg, cfg=cfg)
    return cfg_, jp, jspecs, tp, tspecs, qcfg


def cfg_port(cfg):
    return TModelConfig.from_dict(cfg.to_dict())


def tqcfg(qcfg):
    return TQuantConfig.from_dict(qcfg.to_dict())


def jbits(a):
    a = np.asarray(a)
    return (a.dtype.name, a.view(np.int16) if a.dtype.name == "bfloat16"
            else a)


def tbits(t):
    name = str(t.dtype).replace("torch.", "")
    return (name, (t.view(torch.int16) if t.dtype == torch.bfloat16
                   else t).numpy())


def assert_bit_equal_to_jax(tp, jp):
    """Every leaf of the port's params equal in name, dtype, shape and
    bits to the JAX params' leaf."""
    t, j = tck._leaf_paths(tp), jck._leaf_paths(jp)
    assert [n for n, _ in t] == [n for n, _ in j]
    for (name, a), (_, b) in zip(t, j):
        (ta, va), (tb, vb) = tbits(a), jbits(b)
        assert ta == tb, (name, ta, tb)
        assert va.shape == vb.shape and np.array_equal(va, vb), name


def assert_port_bit_equal(a, b):
    la, lb = tck._leaf_paths(a), tck._leaf_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), name


def port_logits(tp, tspecs, cfg, tokens):
    cache = KVCache.create(cfg.num_hidden_layers, tokens.shape[0], 64,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           torch.bfloat16, device="cpu")
    with torch.inference_mode():
        return forward(tp, torch.from_numpy(tokens), cache, tspecs, cfg,
                       head_f32=lm_head_f32(tp, tspecs))[0]


def jax_logits(jp, jspecs, cfg, tokens):
    cache = JKVCache.create(cfg.num_hidden_layers, tokens.shape[0], 64,
                            cfg.num_key_value_heads, cfg.head_dim_,
                            jnp.bfloat16)
    return np.asarray(j_forward(jp, jnp.asarray(tokens), cache, jspecs,
                                cfg)[0])


def greedy_with_margins(eng, prompts=PROMPTS, new=NEW, rel=5e-3):
    """The port engine's greedy tokens; each step's top-2 margin, replayed
    teacher-forced, clears rel * max|logits|."""
    got = eng.generate(prompts, new)
    toks = np.asarray(got)
    Tp = eng.engine_cfg.prefill_chunk * -(-max(map(len, prompts))
                                          // eng.engine_cfg.prefill_chunk)
    padded = np.zeros((len(prompts), Tp), np.int32)
    kv_start = np.array([Tp - len(p) for p in prompts], np.int32)
    for i, p in enumerate(prompts):
        padded[i, Tp - len(p):] = p
    cache = eng.new_cache(len(prompts), 128)
    logits, cache = eng.prefill(padded, cache, kv_start)
    for step in range(new):
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > rel * logits.abs().max().item(), (step, margin)
        assert (logits.argmax(-1).numpy() == toks[:, step]).all(), step
        if step + 1 < new:
            logits, cache = eng.decode_step(toks[:, step:step + 1], cache,
                                            kv_start)
    return got


def moe_build(seed=0):
    """models.build's tuple for a tiny W8A8 mixtral (4 experts, top 2)
    from JAX's init, carried over by convert.py."""
    cfg = ModelConfig.tiny(model_type="mixtral", num_attention_heads=2,
                           num_key_value_heads=1, num_local_experts=4)
    specs = JSpecs.uniform(JLinearSpec(w_bit=8, a_bit=8))
    jp = j_init(jax.random.PRNGKey(seed), cfg, specs)
    return (cfg, jp, specs,
            decoder_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            TSpecs.uniform(TLinearSpec(w_bit=8, a_bit=8)))


LEAF_CASES = {
    "llama_w8a8o16": lambda: models.build(0),
    "llama_w4a4o16_g128": lambda: models.build(
        0, qcfg=CASES["w4a4o16_g128"][0], cfg=WIDE),
    "llama_w8a16": lambda: models.build(0, qcfg=QuantConfig.w8a16()),
    "llama_fp16": lambda: models.build(0, quantized=False),
    "gemma2": lambda: models.build(0, cfg=gemma2.gemma2_cfg()),
    "baichuan": lambda: models.build(0, cfg=baichuan.alibi_cfg()),
    "mixtral_w8a8": moe_build,
}


@pytest.mark.parametrize("case", list(LEAF_CASES))
def test_leaf_names_equal_jax(case):
    _, jp, _, tp, _ = LEAF_CASES[case]()
    names = [n for n, _ in tck._leaf_paths(tp)]
    assert names == [n for n, _ in jck._leaf_paths(jp)]
    if case == "gemma2":
        assert "blocks.1.post_ffw_norm_scale" in names
    if case == "llama_w8a8o16":
        assert "blocks.1.attn.wq.w_outlier" in names
        assert "blocks.0.mlp.down.out_count" in names
    assert not any(n.startswith("stacked") for n in names)
    moe = [n for n in names if ".moe" in n]
    if case == "mixtral_w8a8":
        assert moe == [f"blocks.{i}.mlp.moe.{leaf}" for i in range(2)
                       for leaf in ("router", "gate.q_weight",
                                    "gate.w_scale", "up.q_weight",
                                    "up.w_scale", "down.q_weight",
                                    "down.w_scale")]
    else:
        assert not moe


@pytest.mark.parametrize("case", list(CASES))
def test_port_save_port_load(case, tmp_path):
    cfg, _, _, tp, tspecs, qcfg = build(case)
    d = str(tmp_path / "ck")
    written = tck.save_checkpoint(d, tp, cfg_port(cfg), tqcfg(qcfg))
    assert written == os.path.getsize(os.path.join(d,
                                                   "model-00000.safetensors"))
    got, mcfg, q2 = tck.load_checkpoint(d, device="cpu")
    assert mcfg == cfg_port(cfg) and q2 == tqcfg(qcfg)
    assert_port_bit_equal(got, tp)
    tokens = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    assert torch.equal(port_logits(got, tspecs, cfg, tokens),
                       port_logits(tp, tspecs, cfg, tokens))


@pytest.mark.parametrize("case", list(CASES))
def test_jax_save_port_load(case, tmp_path):
    cfg, jp, jspecs, tp, tspecs, qcfg = build(case)
    d = str(tmp_path / "ck")
    jck.save_checkpoint(d, jp, cfg, qcfg)
    got, mcfg, q2 = tck.load_checkpoint(d, device="cpu")
    assert mcfg == cfg_port(cfg) and q2 == tqcfg(qcfg)
    assert_port_bit_equal(got, tp)
    assert_bit_equal_to_jax(got, jp)
    # served: the port's greedy tokens from the loaded checkpoint equal
    # JAX's from its own params (batch-major bf16 KV on both sides)
    jspecs = dataclasses.replace(jspecs, attn_impl="xla")
    tspecs = dataclasses.replace(tspecs, attn_impl="xla")
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype="bfloat16")
    eager = jax.disable_jit() if case.startswith("w4") else \
        contextlib.nullcontext()
    with eager:
        ref = JEngine(jp, cfg, jspecs, JEngineConfig(
            device_decode_loop=False, **ecfg)).generate(PROMPTS, NEW)
    eng = InferenceEngine(got, cfg_port(cfg), tspecs, EngineConfig(**ecfg),
                          device="cpu")
    assert greedy_with_margins(eng) == ref


@pytest.mark.parametrize("case", list(CASES))
def test_port_save_jax_load(case, tmp_path):
    cfg, jp, jspecs, tp, _, qcfg = build(case)
    d = str(tmp_path / "ck")
    tck.save_checkpoint(d, tp, cfg_port(cfg), tqcfg(qcfg))
    got, mcfg, q2 = jck.load_checkpoint(d)
    assert mcfg == cfg and q2 == qcfg
    assert_bit_equal_to_jax(tp, got)
    tokens = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jspecs = dataclasses.replace(jspecs, attn_impl="xla")
    assert np.array_equal(jax_logits(got, jspecs, cfg, tokens),
                          jax_logits(jp, jspecs, cfg, tokens))


def test_multi_shard_manifest_equals_jax(tmp_path, monkeypatch):
    """Both packages write the same W4A4O16 g128 params with 64 KB
    shards: equal manifests and configs, several shards, and each loads
    the other's."""
    cfg, jp, _, tp, _, qcfg = build("w4a4o16_g128")
    monkeypatch.setattr(jck, "_SHARD_BYTES", 64 * 1024)
    monkeypatch.setattr(tck, "_SHARD_BYTES", 64 * 1024)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(dj, jp, cfg, qcfg)
    tck.save_checkpoint(dt, tp, cfg_port(cfg), tqcfg(qcfg))
    for name in ("manifest.json", "quant_config.json", "model_config.json"):
        with open(os.path.join(dj, name)) as a, \
                open(os.path.join(dt, name)) as b:
            assert json.load(a) == json.load(b), name
    with open(os.path.join(dt, "manifest.json")) as f:
        shards = {m["shard"] for m in json.load(f)["weights"].values()}
    assert len(shards) > 4 and shards == set(range(len(shards)))
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    assert_port_bit_equal(tck.load_checkpoint(dj, device="cpu")[0], tp)
    assert_bit_equal_to_jax(tp, jck.load_checkpoint(dt)[0])


def _edit_manifest(d, fn):
    p = os.path.join(d, "manifest.json")
    with open(p) as f:
        m = json.load(f)
    fn(m["weights"])
    with open(p, "w") as f:
        json.dump(m, f)


@pytest.fixture
def saved(tmp_path):
    cfg, _, _, tp, _, qcfg = build("w8a8o16")
    d = str(tmp_path / "ck")
    tck.save_checkpoint(d, tp, cfg_port(cfg), tqcfg(qcfg))
    return d, cfg, tp, qcfg


def test_missing_tensor_raises_key_error(saved):
    d = saved[0]
    kept = {}
    _edit_manifest(d, lambda w: kept.update(
        q=w.pop("blocks.1.mlp.down.q_weight")))
    with pytest.raises(KeyError, match="blocks.1.mlp.down.q_weight"):
        tck.load_checkpoint(d, device="cpu")
    _edit_manifest(d, lambda w: w.update(
        {"blocks.1.mlp.down.q_weight": kept["q"]}) or w.pop("embed"))
    with pytest.raises(KeyError, match="'embed'"):
        tck.load_checkpoint(d, device="cpu")


def test_int4_tags_raise(saved):
    d = saved[0]
    _edit_manifest(d, lambda w: w["blocks.0.attn.wq.q_weight"].update(
        dtype="int4_packed"))
    with pytest.raises(NotImplementedError, match="jnp.int4"):
        tck.load_checkpoint(d, device="cpu")


def test_moe_and_stacked_raise(saved, tmp_path):
    """MoE params round-trip bit-equal, and their logits with them;
    stacked params still raise (ROADMAP Queue A item 6)."""
    d, cfg, tp, qcfg = saved
    mcfg, _, _, mp, mspecs = moe_build(1)
    dm = str(tmp_path / "m")
    tck.save_checkpoint(dm, mp, cfg_port(mcfg), tqcfg(qcfg))
    got, c2, _ = tck.load_checkpoint(dm, device="cpu")
    assert c2 == cfg_port(mcfg) and c2.num_local_experts == 4
    assert_port_bit_equal(got, mp)
    toks = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    assert torch.equal(port_logits(got, mspecs, c2, toks),
                       port_logits(mp, mspecs, c2, toks))
    with pytest.raises(NotImplementedError, match="item 6"):
        tck.save_checkpoint(str(tmp_path / "s"),
                            tp._replace(stacked=tp.blocks[0]),
                            cfg_port(cfg), tqcfg(qcfg))


def test_stacked_names_raise(saved):
    d = saved[0]
    _edit_manifest(d, lambda w: w.update(
        {"stacked.ln1_scale": w.pop("blocks.0.ln1_scale")}))
    with pytest.raises(NotImplementedError, match="item 6"):
        tck.load_checkpoint(d, device="cpu")


def test_default_device_is_the_card(saved):
    """No fallback: without device="cpu" the loader reads onto the card,
    and raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tck.load_checkpoint(saved[0])
