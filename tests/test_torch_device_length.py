"""PyTorch port, the decode step with the cache length on the device, on the
CPU.

`KVCache.length` is a 0-dim int32 tensor on the cache's device, with a host
mirror (`host_length`) for the host-side guards; `forward` computes the
write slots, RoPE positions, `kv_len` [B] and each window's start from the
device length. The step that the card captures as a CUDA graph
(`engine.DecodeLoop.step`: forward, sampling, the EOS mask, the buffer
writes) is checked here, run eagerly:

- for N steps it gives logits and cache bits (values, int8 scales, the
  length and its mirror) equal to `InferenceEngine.decode_step` fed the
  same tokens, over the head-major cache, the batch-major one, the tiny
  mistral's 8-slot ring past its wrap and tiny gemma2's alternating
  windows on a batch-major cache where the window binds;
- it reads nothing from the device on the host: Tensor.item, __bool__,
  __int__, __float__, __index__, tolist, cpu and numpy raise while it runs
  (greedy, and sampled with logprobs);
- the cache's setter fills the length and its mirror.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mixq_tpu_torch.config import EngineConfig
from mixq_tpu_torch.engine import InferenceEngine, SamplingParams
from mixq_tpu_torch.engine.engine import DecodeLoop
from mixq_tpu_torch.engine.sampling import chosen_logprob, sample
from mixq_tpu_torch.models.layers import KVCache

import test_torch_gemma2 as gemma2
import test_torch_mistral as mistral
import test_torch_models as models

B = 3
KV_START = [0, 2, 5]


def case(name, kv_dtype):
    """(engine, cache slots, prefill chunks, decode steps) of a case."""
    if name == "mistral ring":         # window 4 on 8 slots: wraps twice
        cfg, _, _, tp, tspecs = mistral.build(1)
        slots, chunks, steps = 8, (4, 4), 12
    elif name == "gemma2 windows":     # window 16 binds on layers 0, 2, ..
        cfg, _, _, tp, tspecs = gemma2.build(3, None,
                                             gemma2.gemma2_cfg(window=16))
        slots, chunks, steps = 32, (16, 4), 8
    else:
        cfg, _, _, tp, tspecs = models.build(1)
        tspecs = dataclasses.replace(
            tspecs, attn_impl="flash" if name == "head-major" else "xla")
        slots, chunks, steps = 32, (8,), 6
    eng = InferenceEngine(tp, cfg, tspecs, EngineConfig(
        max_seq_len=64, prefill_chunk=8, kv_dtype=kv_dtype), device="cpu")
    return eng, slots, chunks, steps


def prefilled(eng, slots, chunks, toks):
    cache = eng.new_cache(B, slots)
    kv_start = torch.tensor(KV_START, dtype=torch.int32)
    p = 0
    for n in chunks:
        logits, cache = eng.prefill(toks[:, p:p + n], cache, kv_start)
        p += n
    return logits, cache, kv_start


CASES = [("head-major", "int8"), ("head-major", "bfloat16"),
         ("batch-major", "int8"), ("batch-major", "bfloat16"),
         ("mistral ring", "int8"), ("mistral ring", "bfloat16"),
         ("gemma2 windows", "int8"), ("gemma2 windows", "bfloat16")]


@pytest.mark.parametrize("name,kv_dtype", CASES)
def test_step_equals_decode_step(name, kv_dtype):
    eng, slots, chunks, steps = case(name, kv_dtype)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, eng.model_cfg.vocab_size, (B, sum(chunks))).astype(np.int32))
    logits, loop_cache, kv_start = prefilled(eng, slots, chunks, toks)
    _, ref_cache, _ = prefilled(eng, slots, chunks, toks)
    assert loop_cache.head_major == (name == "head-major")
    tok = sample(logits, None, SamplingParams())
    loop = DecodeLoop(eng, loop_cache, kv_start, tok, steps + 1,
                      SamplingParams(), None)
    for _ in range(steps):
        fed = loop.tok.clone()
        got = loop.step()
        ref, _ = eng.decode_step(fed, ref_cache, kv_start)
        assert torch.equal(got, ref)
        assert torch.equal(loop.tok[:, 0], torch.argmax(ref, -1).int())
    n = sum(chunks) + steps
    assert loop_cache.host_length == ref_cache.host_length == n
    assert int(loop_cache.length) == int(ref_cache.length) == n
    if name == "mistral ring":
        assert n > 2 * slots
    for f in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(loop_cache, f), getattr(ref_cache, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert loop_cache.quantized == (kv_dtype == "int8")
    # the tokens buffer holds the prefill's token and every step's
    assert torch.equal(loop.tokens[:, 0], tok)
    assert int(loop.col) == steps + 1


HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__",
              "tolist", "cpu", "numpy")


@pytest.mark.parametrize("sampling", [
    SamplingParams(), SamplingParams(temperature=0.7, top_k=20, top_p=0.9)])
@pytest.mark.parametrize("name,kv_dtype", CASES[::2])
def test_step_reads_nothing_on_the_host(name, kv_dtype, sampling,
                                        monkeypatch):
    eng, slots, chunks, steps = case(name, kv_dtype)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        1, eng.model_cfg.vocab_size, (B, sum(chunks))).astype(np.int32))
    logits, cache, kv_start = prefilled(eng, slots, chunks, toks)
    gen = torch.Generator().manual_seed(3)
    tok = sample(logits, gen, sampling)
    loop = DecodeLoop(eng, cache, kv_start, tok, steps + 1, sampling, gen,
                      eos_token_id=int(tok[0]),
                      first_lp=chosen_logprob(logits, tok))

    def refuse(*a, **kw):
        raise AssertionError("the decode step read the device on the host")

    reads = []
    for attr in HOST_READS:
        monkeypatch.setattr(torch.Tensor, attr,
                            lambda *a, attr=attr, **kw: reads.append(attr)
                            or refuse())
    for _ in range(steps):
        loop.step()
    assert not reads
    with pytest.raises(AssertionError):        # the patch is live
        torch.ones(()).item()
    monkeypatch.undo()
    assert reads == ["item"]
    assert cache.host_length == int(cache.length) == sum(chunks) + steps
    assert bool(loop.done[0])          # row 0's first token was the "eos"
    assert (loop.tokens[0, 1:] == loop.eos).all()


def test_set_length_fills_length_and_mirror():
    c = KVCache.create(2, B, 16, 2, 32, device="cpu")
    assert c.length.dtype == torch.int32 and c.length.dim() == 0
    assert c.host_length == 0 and int(c.length) == 0
    c.set_length(9).advance(2)
    assert c.host_length == int(c.length) == 11
    assert torch.equal(c.slots(3), torch.tensor([11, 12, 13]))
    assert torch.equal(c.slots(7, ring=True),
                       torch.tensor([11, 12, 13, 14, 15, 0, 1]))
    with pytest.raises(ValueError, match="cache overflow"):
        c.update_layer(0, torch.zeros(B, 6, 2, 32, dtype=torch.bfloat16),
                       torch.zeros(B, 6, 2, 32, dtype=torch.bfloat16))
