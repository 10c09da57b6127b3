"""PyTorch port: engine and package-level checks on the CPU.

- Greedy `generate` tokens (the port's default, its device decode loop)
  equal the JAX InferenceEngine's (attn_impl="flash"), with JAX's device
  loop off and on, on the same converted tiny W8A8 model, and on the tiny
  W4A4 model of resolve_specs (packed W4A4 q/k/v/up/gate, W8A8 o/down), for
  prompts of different lengths (left padding, so kv_start is live), bf16
  and int8 KV. Each seed is one whose top-2 logit margin stays clear of
  the two packages' logit tolerance at every step; the test asserts that
  margin, so a near-tie shows up as such instead of as a token mismatch.
  The JAX engine runs its forward under jit, where XLA may keep an
  intermediate in f32 that the eager forward (which the port matches to
  ~1e-7, tests/test_torch_decoder.py) rounds to bf16; with 4-bit
  activations such a difference can move a quantization level (1/7 of the
  row's absmax) and change a token even at a clear margin, so the W4A4
  seed is also one where the jitted and the eager JAX engine agree.
- The port's own init_decoder_params (seeded outlier channels) serves
  through its engine, deterministically.
- Importing every module of mixq_tpu_torch pulls in neither jax nor
  mixq_tpu (a fresh subprocess).
- Entry points default to the card.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.engine.sampling import SamplingParams
from mixq_tpu_torch.models.decoder import DecoderSpecs, init_decoder_params
from mixq_tpu_torch.ops.mixed_linear import LinearSpec

import test_torch_models as models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13, 14, 15],
           [42]]
NEW = 6


@pytest.mark.parametrize("jax_loop", [False, True])
@pytest.mark.parametrize("kv_dtype,config,seed", [
    ("bfloat16", None, 1), ("int8", None, 1), ("bfloat16", "w4a4", 8),
    ("int8", "w4a4", 8)])
def test_greedy_tokens_match_jax(kv_dtype, config, seed, jax_loop):
    cfg, jp, jspecs, tp, tspecs = models.build(
        seed=seed, qcfg=models.CONFIGS.get(config))
    ecfg = dict(max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype)
    ref = JEngine(jp, cfg, jspecs, JEngineConfig(
        device_decode_loop=jax_loop, **ecfg)).generate(PROMPTS, NEW)
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(**ecfg),
                          device="cpu")
    got = eng.generate(PROMPTS, NEW)
    assert got == ref
    # no near-ties: replay the port's greedy run and check the margins
    toks = np.asarray(got)
    Tp = 16
    padded = np.zeros((len(PROMPTS), Tp), np.int32)
    kv_start = np.array([Tp - len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        padded[i, Tp - len(p):] = p
    cache = eng.new_cache(len(PROMPTS), 128)
    logits, cache = eng.prefill(padded, cache, kv_start)
    for step in range(NEW):
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        assert margin > 5e-3 * logits.abs().max().item(), (step, margin)
        if step + 1 < NEW:
            logits, cache = eng.decode_step(toks[:, step:step + 1], cache,
                                            kv_start)


def test_port_init_serves_deterministically():
    cfg = ModelConfig.tiny(hidden_size=128, intermediate_size=256,
                           num_attention_heads=4, num_key_value_heads=2)
    specs = DecoderSpecs.uniform(LinearSpec(w_bit=8, a_bit=8))

    def run():
        gen = torch.Generator(device="cpu").manual_seed(7)
        params = init_decoder_params(cfg, specs, gen, device="cpu",
                                     outlier_budget=16)
        wq = params.blocks[0].attn.wq
        assert int(wq.out_count) == 16 and wq.w_outlier.shape == (16, 128)
        assert (params.blocks[0].attn.wk.out_ind == wq.out_ind).all()
        eng = InferenceEngine(params, cfg, specs,
                              EngineConfig(max_seq_len=64, prefill_chunk=8,
                                           kv_dtype="int8"), device="cpu")
        return eng.generate([[1, 2, 3], [4, 5, 6, 7, 8, 9, 10, 11, 12]], 5,
                            sampling=SamplingParams(temperature=0.8,
                                                    top_k=20), seed=1)

    a, b = run(), run()
    assert a == b and [len(r) for r in a] == [5, 5]
    assert all(0 <= x < cfg.vocab_size for r in a for x in r)


def test_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import mixq_tpu_torch\n"
        "for m in pkgutil.walk_packages(mixq_tpu_torch.__path__,"
        " 'mixq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'mixq_tpu') or n.startswith(('jax.', 'jaxlib.', 'mixq_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'mixq_tpu_torch.models.decoder' in sys.modules\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card():
    from mixq_tpu_torch.convert import decoder_params_from_numpy

    for fn in (InferenceEngine.__init__, init_decoder_params,
               decoder_params_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
