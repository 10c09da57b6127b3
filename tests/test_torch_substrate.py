"""PyTorch port, the evaluation substrates (mixq_tpu_torch/utils/substrate.py
and utils/testing.py) against JAX's (mixq_tpu/utils/substrate.py,
utils/testing.py).

The numpy builders draw the same numbers from the same seeds, so their
outputs are bit-equal: synth_corpus (language and sample seeds),
make_markov_state (state and successor table, with and without
share_blocks), plant_outlier_channels, random_hf_state and
hf_state_from_params, whose state also goes through both packages'
params_from_source to the same FP16 logits (within 5e-3 * max|logits|,
tests/test_torch_decoder.py's limit: bf16 activations, where a sum in
another order can flip one rounding that then propagates). The port's
training loss and its gradients at one step equal JAX's loss_fn under
jax.value_and_grad on the same params and batch within 1e-4 relative, each
gradient tensor by its norm (the bf16-stored linears widened to f32 on both
sides, which leaves the forward as it was and the gradients unrounded);
40 port steps bring the
loss below 0.75 ln V (JAX's TestTraining size), and the Markov model
greedily follows its successor table through the port."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.config import ModelConfig as JModelConfig
from mixq_tpu.models import DecoderSpecs as JSpecs
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu.models.decoder import init_decoder_params as j_init
from mixq_tpu.models.hf import params_from_source as j_params_from_source
from mixq_tpu.ops.mixed_linear import LinearSpec as JLinearSpec
from mixq_tpu.utils import substrate as JS
from mixq_tpu.utils.testing import DictSource as JDictSource
from mixq_tpu.utils.testing import random_hf_state as j_random_hf_state
from mixq_tpu_torch.config import ModelConfig, QuantConfig
from mixq_tpu_torch.convert import decoder_params_from_numpy
from mixq_tpu_torch.models import DecoderSpecs, KVCache
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.hf import params_from_source
from mixq_tpu_torch.ops.mixed_linear import LinearSpec
from mixq_tpu_torch.quantize import quantize_model
from mixq_tpu_torch.utils import substrate as TS
from mixq_tpu_torch.utils.testing import DictSource, random_hf_state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts six workers on the cores,
    and small ops split over every core then wait on each other (the
    training steps ran ~60x slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _small(layers=2) -> ModelConfig:
    return ModelConfig(model_type="llama", vocab_size=512, hidden_size=256,
                       intermediate_size=704, num_hidden_layers=layers,
                       num_attention_heads=4, num_key_value_heads=4)


def _jcfg(cfg: ModelConfig) -> JModelConfig:
    return JModelConfig.from_dict(cfg.to_dict())


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,sample_seed,vocab,n", [
    (0, None, 2048, 6000), (3, None, 512, 4000), (0, 1, 2048, 3000),
    (5, 9, 300, 2500)])
def test_synth_corpus_bit_equal(seed, sample_seed, vocab, n):
    got = TS.synth_corpus(vocab, n, seed=seed, sample_seed=sample_seed)
    want = JS.synth_corpus(vocab, n, seed=seed, sample_seed=sample_seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("share_blocks", [False, True])
def test_markov_state_bit_equal(share_blocks):
    cfg = _small(3)
    got, succ = TS.make_markov_state(cfg, v_eff=128, seed=2, margin=7.0,
                                     block_scale=2e-3, mean_cycle=12,
                                     share_blocks=share_blocks)
    want, jsucc = JS.make_markov_state(_jcfg(cfg), v_eff=128, seed=2,
                                       margin=7.0, block_scale=2e-3,
                                       mean_cycle=12,
                                       share_blocks=share_blocks)
    np.testing.assert_array_equal(succ, jsucc)
    _assert_states_equal(got, want)
    name = "self_attn.q_proj.weight"
    aliased = got[f"model.layers.0.{name}"] is got[f"model.layers.2.{name}"]
    assert aliased == share_blocks


def test_plant_outlier_channels_bit_equal():
    """On random_hf_state (itself bit-equal) and on a shared-block Markov
    state planted once through a one-layer cfg, as the 7B gate plants."""
    cfg = _small(2)
    got = random_hf_state(cfg, seed=5, outlier_channels=(3, 9))
    want = j_random_hf_state(_jcfg(cfg), seed=5, outlier_channels=(3, 9))
    _assert_states_equal(got, want)
    TS.plant_outlier_channels(got, cfg, [7, 100, 200], gain=8.0,
                              inner_channels=[3, 50])
    JS.plant_outlier_channels(want, _jcfg(cfg), [7, 100, 200], gain=8.0,
                              inner_channels=[3, 50])
    _assert_states_equal(got, want)

    got, _ = TS.make_markov_state(cfg, v_eff=128, share_blocks=True)
    want, _ = JS.make_markov_state(_jcfg(cfg), v_eff=128, share_blocks=True)
    one = dataclasses.replace(cfg, num_hidden_layers=1)
    TS.plant_outlier_channels(got, one, [1, 2], gain=3.0, inner_channels=[5])
    JS.plant_outlier_channels(want, _jcfg(one), [1, 2], gain=3.0,
                              inner_channels=[5])
    _assert_states_equal(got, want)
    ln = got["model.layers.1.input_layernorm.weight"]
    assert ln[1] == np.float32(3.0) and ln[0] == 1.0   # planted once


def _fp_logits_both(state, cfg, tokens):
    jspecs = JSpecs.fp16()
    jp = j_params_from_source(JDictSource(state), _jcfg(cfg), jspecs)
    jc = JKVCache.create(cfg.num_hidden_layers, 1, tokens.shape[1],
                         cfg.num_key_value_heads, cfg.head_dim_,
                         jnp.bfloat16)
    jl = np.asarray(j_forward(jp, jnp.asarray(tokens), jc, jspecs,
                              _jcfg(cfg))[0])
    specs = DecoderSpecs.fp16()
    tp = params_from_source(DictSource(state), cfg, specs, device="cpu")
    tc = KVCache.create(cfg.num_hidden_layers, 1, tokens.shape[1],
                        cfg.num_key_value_heads, cfg.head_dim_,
                        torch.bfloat16, device="cpu")
    tl = forward(tp, torch.from_numpy(tokens), tc, specs, cfg,
                 head_f32=lm_head_f32(tp, specs))[0].numpy()
    return tl, jl


def test_hf_state_round_trip():
    """A JAX FP16 model carried to the port (decoder_params_from_numpy):
    hf_state_from_params of both sides is the same dict, and through each
    package's params_from_source it gives the same logits."""
    cfg = _small(2)
    jp = j_init(jax.random.PRNGKey(4), _jcfg(cfg), JSpecs.fp16())
    tp = decoder_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    got = TS.hf_state_from_params(tp, cfg)
    want = JS.hf_state_from_params(jp, _jcfg(cfg))
    _assert_states_equal(got, want)
    toks = np.random.default_rng(0).integers(2, 512, (1, 24)).astype(
        np.int32)
    tl, jl = _fp_logits_both(got, cfg, toks)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-3 * np.abs(jl).max())


def _j_loss(params, tokens, cfg, specs):
    """JAX's loss_fn of train_tiny_lm (mixq_tpu/utils/substrate.py)."""
    B, T = tokens.shape[0], tokens.shape[1] - 1
    cache = JKVCache.create(cfg.num_hidden_layers, B, T,
                            cfg.num_key_value_heads, cfg.head_dim_,
                            jnp.float32)
    logits, _ = j_forward(params, tokens[:, :-1], cache, specs, cfg)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    nll = -jnp.take_along_axis(logp, tokens[:, 1:][..., None], axis=-1)
    return nll.mean()


def test_first_step_loss_and_grads_equal_jax():
    cfg = dataclasses.replace(TS.substrate_cfg("tiny"), num_hidden_layers=2)
    jcfg = _jcfg(cfg)
    jspecs = JSpecs.uniform(JLinearSpec(version="FP16", w_bit=16,
                                        out_dtype="float32"))
    jp = j_init(jax.random.PRNGKey(0), jcfg, jspecs, dtype=jnp.float32)
    # the linears are stored in bf16; widened to f32 (exactly), the forward
    # is the same and the gradients come unrounded on both sides
    jp = jax.tree.map(lambda a: a.astype(jnp.float32)
                      if a.dtype == jnp.bfloat16 else a, jp)
    corpus = TS.synth_corpus(cfg.vocab_size, 4000, seed=0)
    starts = np.random.RandomState(1).randint(0, len(corpus) - 33, 4)
    batch = np.stack([corpus[s:s + 33] for s in starts])
    jloss, jgrads = jax.value_and_grad(_j_loss)(jp, jnp.asarray(batch),
                                                jcfg, jspecs)

    specs = DecoderSpecs.uniform(LinearSpec(version="FP16", w_bit=16,
                                            out_dtype="float32"))
    tp = decoder_params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    leaves = TS.trainable(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = TS.lm_loss(tp, torch.from_numpy(batch), cfg, specs)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)

    jg = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    want = [jg.embed, jg.lnf_scale, jg.lm_head]
    for b in jg.blocks:
        want += [b.ln1_scale, b.ln2_scale]
        want += [lin.q_weight for lin in (b.attn.wq, b.attn.wk, b.attn.wv,
                                          b.attn.wo, b.mlp.up, b.mlp.gate,
                                          b.mlp.down)]
    assert len(want) == len(leaves)
    for t, w in zip(leaves, want):
        g = t.grad.float().numpy()
        assert g.shape == w.shape and t.grad.dtype == t.dtype
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w)


def test_training_drops_below_chance_and_quantizes():
    """40 steps at JAX's TestTraining size, on the CPU; the trained model
    goes through hf_state_from_params into quantize_model."""
    cfg = TS.substrate_cfg("tiny")
    corpus = TS.synth_corpus(cfg.vocab_size, 20000, seed=0)
    params, loss = TS.train_tiny_lm(cfg, corpus, steps=40, batch=8,
                                    seq_len=64, device="cpu")
    assert loss < 0.75 * np.log(cfg.vocab_size)
    assert not any(t.requires_grad for t in TS.trainable(params))
    state = TS.hf_state_from_params(params, cfg)
    qp, _ = quantize_model(DictSource(state), cfg,
                           QuantConfig.w8a8(outlier_budget=8), device="cpu")
    assert qp.blocks[0].attn.wq.q_weight.dtype == torch.int8


def test_markov_greedy_follows_chain():
    """JAX's TestMarkovLM through the port: 12 greedy decode steps emit the
    successor table."""
    cfg = _small(2)
    state, succ = TS.make_markov_state(cfg, v_eff=128, seed=0)
    specs = DecoderSpecs.fp16()
    params = params_from_source(DictSource(state), cfg, specs, device="cpu")
    head = lm_head_f32(params, specs)
    cache = KVCache.create(cfg.num_hidden_layers, 1, 32,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           torch.bfloat16, device="cpu")
    toks = [5]
    with torch.inference_mode():
        for _ in range(12):
            logits, cache = forward(params, torch.tensor([[toks[-1]]]),
                                    cache, specs, cfg, head_f32=head)
            toks.append(int(torch.argmax(logits[0, -1])))
    want = [5]
    for _ in range(12):
        want.append(int(succ[want[-1]]))
    assert toks == want


def test_device_state_keeps_aliasing():
    cfg = _small(3)
    state, _ = TS.make_markov_state(cfg, v_eff=128, share_blocks=True)
    dev = TS.device_state(state, "cpu")
    name = "mlp.up_proj.weight"
    assert dev[f"model.layers.0.{name}"] is dev[f"model.layers.2.{name}"]
    for k, v in state.items():
        np.testing.assert_array_equal(dev[k].numpy(), v)
