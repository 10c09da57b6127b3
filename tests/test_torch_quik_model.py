"""PyTorch port: a tiny QUIK W4A4 llama end to end against mixq_tpu on the
CPU (tests/test_quantize_pipeline.py's `make_hf_style_state`, budget 16: a
multiple of 16, so the same params run on the card's kernels).

- quantize_model(quik_w4a4) from the same act scales (JAX's calibration,
  rounded to 1/8ths so that ties sit at the cuts): every leaf bit-equal to
  JAX's, reduced_w included; q/k/v/up/gate QUIK W4A4 (packed), o/down QUIK
  W8A8, every linear with its calibrated set (q/k/v share "{i}.wqkv"'s).
- quantize_model(quik_w4a4, calib_batches) on both sides with 16 boosted
  embedding channels: the q/k/v and up/gate sets equal JAX's, and those
  linears bit-equal (the scales themselves differ by JAX's jit-vs-eager
  spread, tests/test_torch_quantize_pipeline.py).
- Greedy tokens of the port's InferenceEngine (device loop and stepwise)
  equal JAX's engine under jax.disable_jit() (JAX's jitted W4A4 path
  leaves its own eager path, ROADMAP.md Queue C), each step's top-2
  margin asserted above 5e-3 of max|logits|; the continuous-batching
  engine's slot-mode forward serves the same greedy tokens.
- Checkpoints both ways: the port's save loads in JAX bit-equal and JAX's
  loads in the port bit-equal, with equal logits.
- warmup_online leaves every QUIK param unchanged (JAX online.py:84).
- QUIK with a q_group_size raises ValueError in resolve_specs and in
  quantize_model (tests/test_quantize_pipeline.py:320).
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import ModelConfig, QuantConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.models.decoder import DecoderSpecs as JSpecs
from mixq_tpu.models.hf import params_from_source as j_params_from_source
from mixq_tpu.quantize import calibration as jcal
from mixq_tpu.quantize import checkpoint as jck
from mixq_tpu.quantize import quantize_model as j_quantize_model
from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.engine.batching import ContinuousBatchingEngine
from mixq_tpu_torch.models.hf import TensorSource
from mixq_tpu_torch.quantize import checkpoint as tck
from mixq_tpu_torch.quantize import quantize_model, resolve_specs
from test_quantize_pipeline import FakeSource, make_hf_style_state
from test_torch_batching import assert_margins
from test_torch_checkpoint import (assert_bit_equal_to_jax,
                                   assert_port_bit_equal, greedy_with_margins,
                                   jax_logits, port_logits)
from test_torch_hf_source import assert_tree_equal
from test_torch_quantize_pipeline import batches, planted_state, port

BUDGET = 16
# make_hf_style_state's seed: its logits are flat (max ~0.4), and seed 2 is
# the first of 1-15 whose greedy steps all clear the asserted margin under
# every layout tested here (seeds 9 and 12 do too)
STATE_SEED = 2
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6
ECFG = dict(max_seq_len=64, prefill_chunk=8, kv_dtype="bfloat16")


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread (tests/test_torch_substrate.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qcfg():
    return QuantConfig.quik_w4a4(outlier_budget=BUDGET)


@pytest.fixture(scope="module")
def world():
    """(cfg, JAX params, JAX specs, port params, port specs) of one tiny
    QUIK model quantized from the same act scales on both sides."""
    cfg = ModelConfig.tiny()
    state = make_hf_style_state(cfg, seed=STATE_SEED)
    scales = jcal.collect_act_scales(
        j_params_from_source(FakeSource(state), cfg, JSpecs.fp16()), cfg,
        batches(cfg))
    scales = {k: np.round(v * 8) / 8 for k, v in scales.items()}
    jp, jspecs = j_quantize_model(FakeSource(state), cfg, qcfg(),
                                  act_scales=scales)
    tp, tspecs = quantize_model(TensorSource.from_dict(state),
                                *port(cfg, qcfg()), act_scales=scales,
                                device="cpu")
    return cfg, jp, jspecs, tp, tspecs


def test_params_bit_equal_to_jax(world):
    cfg, jp, jspecs, tp, tspecs = world
    assert_tree_equal(jax.tree.map(np.asarray, jp), tp)
    assert dataclasses.asdict(tspecs) == dataclasses.asdict(jspecs)
    assert (tspecs.wqkv.version, tspecs.wqkv.w_bit, tspecs.wqkv.a_bit) == (
        "QUIK", 4, 4)
    assert (tspecs.down.version, tspecs.down.w_bit, tspecs.down.a_bit) == (
        "QUIK", 8, 8)
    b = tp.blocks[1]
    assert b.attn.wq.q_weight.dtype == torch.uint8
    assert b.attn.wo.q_weight.dtype == torch.int8
    for lin in (b.attn.wq, b.attn.wo, b.mlp.gate, b.mlp.down):
        assert lin.reduced_w is not None
        assert int(lin.out_count) == BUDGET
    assert torch.equal(b.attn.wq.out_ind, b.attn.wv.out_ind)
    assert torch.equal(b.mlp.up.out_ind, b.mlp.gate.out_ind)


def test_calibrated_sets_and_params_as_jax():
    cfg = ModelConfig.tiny()
    state = planted_state(cfg)
    jp, _ = j_quantize_model(FakeSource(state), cfg, qcfg(),
                             calib_batches=batches(cfg))
    tp, _ = quantize_model(TensorSource.from_dict(state), *port(cfg, qcfg()),
                           calib_batches=batches(cfg), device="cpu")
    jp = jax.tree.map(np.asarray, jp)
    for jb, tb in zip(jp.blocks, tp.blocks):
        for part, names in (("attn", ("wq", "wk", "wv")),
                            ("mlp", ("up", "gate"))):
            for name in names:
                jl = getattr(getattr(jb, part), name)
                tl = getattr(getattr(tb, part), name)
                assert set(jl.out_ind.tolist()) == set(tl.out_ind.tolist())
                assert_tree_equal(
                    jl._replace(out_ind=None, w_outlier=None),
                    tl._replace(out_ind=None, w_outlier=None), name)


def jax_tokens(jp, jspecs, cfg):
    jspecs = dataclasses.replace(jspecs, attn_impl="xla")
    with jax.disable_jit():
        return JEngine(jp, cfg, jspecs, JEngineConfig(
            device_decode_loop=False, **ECFG)).generate(PROMPTS, NEW)


@pytest.fixture(scope="module")
def reference_tokens(world):
    cfg, jp, jspecs = world[:3]
    return jax_tokens(jp, jspecs, cfg)


@pytest.mark.parametrize("device_loop", [True, False])
def test_greedy_tokens_equal_jax(world, reference_tokens, device_loop):
    cfg, _, _, tp, tspecs = world
    tcfg = port(cfg, qcfg())[0]
    eng = InferenceEngine(tp, tcfg, dataclasses.replace(
        tspecs, attn_impl="xla"), EngineConfig(
        device_decode_loop=device_loop, **ECFG), device="cpu")
    assert greedy_with_margins(eng, PROMPTS, NEW) == reference_tokens


@pytest.mark.parametrize("attn,kv", [("auto", "bfloat16"),
                                     ("flash", "int8")])
def test_slot_mode_serves_quik(world, attn, kv):
    cfg, _, _, tp, tspecs = world
    tcfg = port(cfg, qcfg())[0]
    eng = ContinuousBatchingEngine(
        tp, tcfg, dataclasses.replace(tspecs, attn_impl=attn), EngineConfig(
            max_batch_size=3, max_seq_len=64, prefill_chunk=8, kv_dtype=kv),
        device="cpu")
    ids = [eng.add_request(p, NEW) for p in PROMPTS]
    out = eng.run_to_completion()
    got = [out[i] for i in ids]
    assert [len(g) for g in got] == [NEW] * len(PROMPTS)
    assert_margins(eng, PROMPTS, got)


def test_port_checkpoint_loads_in_jax(world, tmp_path):
    cfg, jp, jspecs, tp, _ = world
    d = str(tmp_path / "ck")
    tck.save_checkpoint(d, tp, *port(cfg, qcfg()))
    got, mcfg, q2 = jck.load_checkpoint(d)
    assert mcfg == cfg and q2 == qcfg()
    assert_bit_equal_to_jax(tp, got)
    assert got.blocks[0].attn.wq.reduced_w is not None
    tokens = np.random.default_rng(4).integers(1, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jspecs = dataclasses.replace(jspecs, attn_impl="xla")
    with jax.disable_jit():
        assert np.array_equal(jax_logits(got, jspecs, cfg, tokens),
                              jax_logits(jp, jspecs, cfg, tokens))


def test_jax_checkpoint_loads_in_port(world, tmp_path):
    cfg, jp, _, tp, tspecs = world
    d = str(tmp_path / "ck")
    jck.save_checkpoint(d, jp, cfg, qcfg())
    assert os.path.exists(os.path.join(d, "manifest.json"))
    got, mcfg, q2 = tck.load_checkpoint(d, device="cpu")
    assert (mcfg, q2) == port(cfg, qcfg())
    assert_port_bit_equal(got, tp)
    assert_bit_equal_to_jax(got, jp)
    assert resolve_specs(q2) == tspecs
    tokens = np.random.default_rng(3).integers(1, cfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    assert torch.equal(port_logits(got, tspecs, cfg, tokens),
                       port_logits(tp, tspecs, cfg, tokens))


def test_warmup_online_leaves_quik_alone(world):
    cfg, _, _, tp, tspecs = world
    tcfg = port(cfg, qcfg())[0]
    eng = InferenceEngine(tp, tcfg, tspecs, EngineConfig(**ECFG),
                          device="cpu")
    before = eng.params
    batch = np.arange(1, 33, dtype=np.int32).reshape(2, 16) * 7 % 256
    # a low sigma that would promote channels of a MIX linear
    eng.warmup_online([batch, batch], sigma=0.5)
    assert_port_bit_equal(eng.params, before)


def test_group_size_raises():
    cfg = ModelConfig.tiny()
    grouped = dataclasses.replace(qcfg(), q_group_size=128)
    tcfg, tq = port(cfg, grouped)
    with pytest.raises(ValueError, match="group"):
        resolve_specs(tq)
    with pytest.raises(ValueError, match="group"):
        quantize_model(TensorSource.from_dict(make_hf_style_state(cfg)),
                       tcfg, tq, calib_batches=batches(cfg), device="cpu")
