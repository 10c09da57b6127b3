"""PyTorch port: models/auto.py, models/hf.py's safetensors directories and
utils/calib_data.py against the JAX package, on a tiny HF llama written by
transformers' save_pretrained (hidden 128, head_dim 32, 2 layers), once
as one F32 `model.safetensors` and once in bf16, sharded, with
`model.safetensors.index.json`.

- TensorSource.from_safetensors_dir(...).get equals JAX's on every name,
  in the stored dtype (bf16 stays bf16; JAX widens it exactly).
- AutoModel.from_pretrained fp16 / w8a8 / w4a4 with calibration batches
  gives params bit-equal to JAX's AutoModel.from_pretrained through
  convert.decoder_params_from_numpy; so does load_model.
- AutoModel.engine (on the HF directory, and on a checkpoint saved from
  it) serves JAX's greedy tokens, top-2 margins asserted; serving_engine
  drains a few requests to the engine's greedy tokens.
- An unported model_type raises NotImplementedError; a tiny mixtral
  directory (the MoE slice) loads W8A8 bit-equal to JAX's from_pretrained
  and AutoModel.engine serves it.
- blocks_from_tokens and get_calib_dataset equal JAX's."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from transformers import LlamaConfig, LlamaForCausalLM

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import QuantConfig
from mixq_tpu.models import hf as jhf
from mixq_tpu.models.auto import AutoModel as JAutoModel
from mixq_tpu.utils import calib_data as jcd
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.models.auto import AutoModel
from mixq_tpu_torch.quantize import save_checkpoint
from mixq_tpu_torch.utils import calib_data as tcd

import test_torch_checkpoint as ck

ECFG = dict(max_seq_len=64, prefill_chunk=8, kv_dtype="bfloat16")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{"f32": one model.safetensors, "bf16": bf16 shards + index}."""
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=128)
    # a seed whose greedy runs keep their top-2 margins (asserted)
    torch.manual_seed(4)
    model = LlamaForCausalLM(cfg).eval()
    with torch.no_grad():       # norms away from ones, so a swap shows
        for n, p in model.named_parameters():
            if "norm" in n:
                p.copy_(1 + 0.1 * torch.randn_like(p))
    dirs = {}
    for kind in ("f32", "bf16"):
        d = str(tmp_path_factory.mktemp(f"hf_{kind}"))
        if kind == "f32":
            model.save_pretrained(d, safe_serialization=True)
        else:
            model.to(torch.bfloat16).save_pretrained(
                d, safe_serialization=True, max_shard_size="200KB")
        dirs[kind] = d
    assert os.path.exists(os.path.join(dirs["f32"], "model.safetensors"))
    with open(os.path.join(dirs["bf16"],
                           "model.safetensors.index.json")) as f:
        assert len(set(json.load(f)["weight_map"].values())) > 2
    return dirs


def calib():
    rng = np.random.RandomState(5)
    return [rng.randint(1, 256, (1, 64)).astype(np.int32) for _ in range(2)]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_source_equals_jax(hf_dirs, kind):
    d = hf_dirs[kind]
    js = jhf.TensorSource.from_safetensors_dir(d)
    ts = thf.TensorSource.from_safetensors_dir(d)
    names = [n for n in LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2)).state_dict()]
    want = torch.bfloat16 if kind == "bf16" else torch.float32
    for n in names:
        assert js.has(n) and ts.has(n), n
        t, j = ts.get(n), np.asarray(js.get(n), np.float32)
        assert t.dtype == want, n
        assert np.array_equal(t.float().numpy(), j), n
    assert not ts.has("model.layers.9.mlp.up_proj.weight")


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("config", ["fp16", "w8a8", "w4a4"])
def test_from_pretrained_equals_jax(hf_dirs, kind, config):
    d = hf_dirs[kind]
    qcfg = {"fp16": None, "w8a8": QuantConfig.w8a8(outlier_budget=16),
            "w4a4": QuantConfig.w4a4(outlier_budget=16)}[config]
    kw = {"calib_batches": calib()} if config == "w4a4" else {}
    # JAX calibrates under jit by default, where its scales leave its own
    # eager path by up to ~7.5e-3 of a key's max and move the sets' order
    # (ROADMAP Queue C); the port matches the eager path
    with jax.disable_jit(config == "w4a4"):
        jp, jcfg, jspecs = JAutoModel.from_pretrained(d, quant_config=qcfg,
                                                      **kw)
    tp, tcfg, tspecs = AutoModel.from_pretrained(
        d, quant_config=None if qcfg is None else TQuantConfig.from_dict(
            qcfg.to_dict()), device="cpu", **kw)
    assert tcfg == ck.cfg_port(jcfg)
    ck.assert_port_bit_equal(tp, decoder_params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"))
    if config == "fp16":
        lp, lcfg = thf.load_model(d, device="cpu")
        assert lcfg == tcfg
        ck.assert_port_bit_equal(lp, tp)


def test_engine_tokens_equal_jax(hf_dirs, tmp_path):
    """fp16 from the HF directory, and W8A8O16 from a checkpoint the port
    saved of it (the manifest picks the quantized loader)."""
    d = hf_dirs["bf16"]
    prompts = ck.PROMPTS
    ref = JAutoModel.engine(d, JEngineConfig(**ECFG)).generate(prompts,
                                                               ck.NEW)
    eng = AutoModel.engine(d, EngineConfig(**ECFG), device="cpu")
    assert eng.specs.wqkv.version == "FP16"
    assert ck.greedy_with_margins(eng, prompts) == ref

    q = QuantConfig.w8a8(outlier_budget=16)
    params, cfg, _ = AutoModel.from_pretrained(
        d, TQuantConfig.from_dict(q.to_dict()), device="cpu")
    qdir = str(tmp_path / "w8a8")
    save_checkpoint(qdir, params, cfg, TQuantConfig.from_dict(q.to_dict()))
    ref = JAutoModel.engine(qdir, JEngineConfig(**ECFG)).generate(prompts,
                                                                  ck.NEW)
    eng = AutoModel.engine(qdir, EngineConfig(**ECFG), device="cpu")
    assert eng.specs.wqkv.a_bit == 8
    assert ck.greedy_with_margins(eng, prompts) == ref


def test_serving_engine_drains(hf_dirs):
    d = hf_dirs["f32"]
    eng = AutoModel.serving_engine(
        d, EngineConfig(max_batch_size=2, **ECFG), device="cpu")
    ids = [eng.add_request(p, 5) for p in ck.PROMPTS[:3]]
    out = eng.run_to_completion()
    single = AutoModel.engine(d, EngineConfig(**ECFG), device="cpu")
    for rid, p in zip(ids, ck.PROMPTS[:3]):
        assert out[rid] == single.generate([p], 5)[0], p
    assert not eng.has_work


def test_unported_family_raises(hf_dirs, tmp_path):
    d = str(tmp_path / "jamba")
    shutil.copytree(hf_dirs["f32"], d)
    with open(os.path.join(d, "config.json")) as f:
        hf = json.load(f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(dict(hf, model_type="jamba"), f)
    for call in (AutoModel.from_pretrained, AutoModel.engine):
        with pytest.raises(NotImplementedError, match="not ported"):
            call(d, device="cpu")
    with pytest.raises(NotImplementedError):
        thf.load_model(d, device="cpu")
    # mixtral loads: transformers' tiny model written as a directory
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(4)
    model = MixtralForCausalLM(MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128)).eval()
    dm = str(tmp_path / "mixtral")
    model.save_pretrained(dm, safe_serialization=True)
    params, cfg, specs = AutoModel.from_pretrained(dm, TQuantConfig.w8a8(),
                                                   device="cpu")
    jp, jcfg, _ = JAutoModel.from_pretrained(dm, QuantConfig.w8a8())
    assert cfg.num_local_experts == 4 and params.blocks[0].mlp.moe
    ck.assert_port_bit_equal(params, decoder_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    eng = AutoModel.engine(dm, EngineConfig(**ECFG), device="cpu")
    assert eng.params.blocks[1].mlp.moe is not None
    assert [len(t) for t in eng.generate(ck.PROMPTS[:2], 3)] == [3, 3]


def test_calib_data_equals_jax(tmp_path):
    stream = np.random.RandomState(1).randint(0, 1000, 5000)
    for n, L in ((4, 512), (64, 256), (3, 1000)):
        a, b = jcd.blocks_from_tokens(stream, n, L), tcd.blocks_from_tokens(
            stream, n, L)
        assert len(a) == len(b) and all(
            x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tcd.blocks_from_tokens(stream[:10], 4, 512)
    p = str(tmp_path / "t.npy")
    np.save(p, stream)
    text = str(tmp_path / "t.txt")
    with open(text, "w") as f:
        f.write("x" * 3000)

    class Tok:
        def __call__(self, s):
            return type("Enc", (), {"input_ids": [ord(c) % 97 for c in s]})

    for kw in (dict(tokens_path=p, n_samples=5, block_len=128),
               dict(text_path=text, tokenizer=Tok(), n_samples=3,
                    block_len=512),
               dict(vocab_size=300, n_samples=4, block_len=32, seed=7)):
        a, b = jcd.get_calib_dataset(**kw), tcd.get_calib_dataset(**kw)
        assert len(a) == len(b) > 0 and all(
            x.dtype == y.dtype and np.array_equal(x, y)
            for x, y in zip(a, b)), kw
    with pytest.raises(ValueError, match="tokenizer"):
        tcd.get_calib_dataset(text_path=text)
