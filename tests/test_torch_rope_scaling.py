"""PyTorch port, RoPE scaling, partial rotary dims and the RMSNorm families'
configs on the CPU, against the JAX package.

- rope_cos_sin with no scaling, "linear", "llama3" (Llama-3.1's factors)
  and "longrope" (per-frequency factors and an attention factor), at
  rotary dims 32, 64 and 128 and positions up to 131,072: the angles, read
  by running both packages' rope_cos_sin with cos and sin replaced by the
  identity, are bit-equal (the frequencies and their scaling in JAX's
  operation order). The tables themselves are held to 2^-22 * (att +
  |angle|), att the attention factor (1 unless longrope): XLA's and
  PyTorch's cos and sin
  differ by an f32 ulp now and then, and at rotary dim 96 their f32 pow
  differs by an ulp in one frequency, which moves an angle by at most an
  ulp of itself.
- The decoder's scaling tuple (models.decoder.rope_scaling): longrope takes
  its short factors for a cache of max_seq <= original context + 256 and
  its long ones past it, JAX's rule (mixq_tpu/models/decoder.py:441-454),
  checked at the edge through both packages' forward.
- apply_rope with a partial rotary dim (neox, the pass-through tail) and
  with the full head: bit-equal to JAX's on the same tables; gptj still
  raises (ROADMAP.md Queue A item 6).
- config_from_hf for qwen2, qwen3, phi3 (plain, longrope, legacy "su" with
  partial_rotary_factor), gemma (hidden_act before hidden_activation),
  aquila, llama with llama3 and linear scaling: dataclasses.asdict equal
  to JAX's; yarn and dynamic scaling raise ValueError as in JAX; the five
  presets equal JAX's config_from_hf of their published configs.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from mixq_tpu.models import hf as jhf
from mixq_tpu.models import layers as jlayers
from mixq_tpu_torch import presets
from mixq_tpu_torch.models import decoder as tdecoder
from mixq_tpu_torch.models import hf as thf
from mixq_tpu_torch.models import layers as tlayers

LLAMA3 = ("llama3", 8.0, 1.0, 4.0, 8192)
SCALINGS = {
    "none": None,
    "linear": ("linear", 4.0),
    "llama3": LLAMA3,
    # a short context: the smoothed band covers mid frequencies at dim 32
    "llama3_short": ("llama3", 8.0, 1.0, 4.0, 64),
    "longrope": "longrope",
}
POSITIONS = np.array([0, 1, 2, 17, 255, 4095, 8191, 8192, 32768, 131071],
                     np.int32)


def _scaling(name, dim):
    s = SCALINGS[name]
    if s == "longrope":
        rng = np.random.default_rng(dim)
        factors = tuple(float(f) for f in 1.0 + 3.0 * rng.random(dim // 2))
        return ("longrope", factors, 1.1902380714238083)
    return s


def _identity_trig(monkeypatch):
    """cos and sin as the identity in both modules' numerics: JAX's
    layers module reads them from its `jnp`, the port's from its
    `torch`."""
    jproxy = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                      if not n.startswith("__")})
    jproxy.cos = jproxy.sin = lambda x: x
    tproxy = types.SimpleNamespace(**{n: getattr(torch, n)
                                      for n in dir(torch)
                                      if not n.startswith("__")})
    tproxy.cos = tproxy.sin = lambda x: x
    monkeypatch.setattr(jlayers, "jnp", jproxy)
    monkeypatch.setattr(tlayers, "torch", tproxy)


def _tables(dim, scaling, positions):
    jc, js = jlayers.rope_cos_sin(jnp.asarray(positions), dim, 500000.0,
                                  scaling=scaling)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(positions), dim,
                                  500000.0, scaling)
    return (np.asarray(jc), np.asarray(js)), (tc.numpy(), ts.numpy())


@pytest.mark.parametrize("name", list(SCALINGS))
@pytest.mark.parametrize("dim", [32, 64, 128])
def test_angles_bit_equal_to_jax(monkeypatch, name, dim):
    scaling = _scaling(name, dim)
    with monkeypatch.context() as m:
        _identity_trig(m)
        (ja, ja2), (ta, ta2) = _tables(dim, scaling, POSITIONS)
        (plain, _), _ = _tables(dim, None, POSITIONS)
    assert ta.dtype == np.float32 and ta.shape == (len(POSITIONS), dim // 2)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(ta2, ja2)
    if name != "none":              # the scaling moves the frequencies
        assert not np.array_equal(plain, ja)


@pytest.mark.parametrize("name", list(SCALINGS))
@pytest.mark.parametrize("dim", [32, 96, 128])
def test_tables_within_an_ulp_of_the_angle(monkeypatch, name, dim):
    scaling = _scaling(name, dim)
    att = scaling[2] if name == "longrope" else 1.0
    with monkeypatch.context() as m:
        _identity_trig(m)
        (angle, _), _ = _tables(dim, scaling, POSITIONS)
    (jc, js), (tc, ts) = _tables(dim, scaling, POSITIONS)
    tol = 2.0 ** -22 * (att + np.abs(angle.astype(np.float64)))
    assert (np.abs(tc - jc) <= tol).all() and (np.abs(ts - js) <= tol).all()
    # most entries are bit-equal: the difference is the libraries' trig
    assert (tc == jc).mean() > 0.5 and (ts == js).mean() > 0.5


@pytest.mark.parametrize("rot", [None, 24, 12])
def test_apply_rope_partial_rotary_bit_equal(rot):
    rng = np.random.default_rng(rot or 0)
    B, T, H, D = 2, 5, 3, 32
    x = rng.standard_normal((B, T, H, D)).astype(np.float32)
    r = rot or D
    cos = rng.standard_normal((T, r // 2)).astype(np.float32)
    sin = rng.standard_normal((T, r // 2)).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x, dtype)
        got = tlayers.apply_rope(
            torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
                torch.float32 if dtype == jnp.float32 else torch.bfloat16),
            torch.from_numpy(cos), torch.from_numpy(sin), "neox", rot)
        ref = jlayers.apply_rope(xj, jnp.asarray(cos), jnp.asarray(sin),
                                 "neox", rot)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
        if rot:                     # the tail passes through untouched
            np.testing.assert_array_equal(
                got[..., rot:].float().numpy(),
                np.asarray(xj[..., rot:].astype(jnp.float32)))
    # gptj's style is ported (tests/test_torch_layernorm_families.py); a
    # style neither package has raises, as in JAX
    with pytest.raises(ValueError, match="unknown rope style"):
        tlayers.apply_rope(torch.zeros(1, 1, 1, 8), torch.zeros(1, 4),
                           torch.zeros(1, 4), "glm")


def _longrope_cfg():
    return thf.config_from_hf(transformers.Phi3Config(
        vocab_size=64, hidden_size=64, intermediate_size=96,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=512, original_max_position_embeddings=64,
        pad_token_id=0,
        rope_scaling={"type": "longrope",
                      "short_factor": [1.0 + 0.1 * i for i in range(16)],
                      "long_factor": [4.0 + 0.5 * i for i in range(16)]},
    ).to_dict())


def test_longrope_factor_choice_at_the_edge():
    """Short factors up to original context + 256 slots, long past it: the
    scaling tuple, and both packages' forward on caches of 320 and 321
    slots (the first step's logits agree with JAX's on each, and the two
    caches give different logits)."""
    from mixq_tpu.config import ModelConfig as JModelConfig
    from mixq_tpu.models import KVCache as JKVCache
    from mixq_tpu.models.decoder import DecoderSpecs as JSpecs
    from mixq_tpu.models.decoder import forward as j_forward
    from mixq_tpu.models.decoder import init_decoder_params
    from mixq_tpu_torch.convert import decoder_params_from_numpy
    from mixq_tpu_torch.models.layers import KVCache

    cfg = _longrope_cfg()
    edge = cfg.rope_original_max_position + 256
    assert tdecoder.rope_scaling(cfg, edge)[1] == cfg.rope_short_factor
    assert tdecoder.rope_scaling(cfg, edge + 1)[1] == cfg.rope_long_factor
    assert tdecoder.rope_scaling(cfg, edge)[2] == cfg.rope_attention_factor
    jcfg = JModelConfig.from_dict(cfg.to_dict())
    jp = init_decoder_params(jax.random.PRNGKey(3), jcfg, JSpecs.fp16())
    tp = decoder_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tspecs = tdecoder.DecoderSpecs.fp16()
    head = tdecoder.lm_head_f32(tp, tspecs)
    toks = np.random.default_rng(1).integers(0, 64, (1, 40)).astype(
        np.int32)
    out = []
    for S in (edge, edge + 1):
        jl, _ = j_forward(jp, jnp.asarray(toks), JKVCache.create(
            1, 1, S, 2, 32, jnp.bfloat16), JSpecs.fp16(), jcfg)
        tl, _ = tdecoder.forward(tp, torch.from_numpy(toks), KVCache.create(
            1, 1, S, 2, 32, torch.bfloat16, device="cpu"), tspecs, cfg,
            head_f32=head)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=5e-3 * np.abs(jl).max())
        out.append(tl)
    assert not torch.equal(out[0], out[1])


# tiny HF configs of each family, made by transformers' own classes
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
HF_CONFIGS = {
    "qwen2": lambda: transformers.Qwen2Config(**TINY).to_dict(),
    "qwen2_g7": lambda: transformers.Qwen2Config(
        **{**TINY, "hidden_size": 224, "num_attention_heads": 7,
           "num_key_value_heads": 1}).to_dict(),
    "qwen2_window": lambda: transformers.Qwen2Config(
        **TINY, use_sliding_window=True, sliding_window=32).to_dict(),
    "qwen3": lambda: transformers.Qwen3Config(**TINY, head_dim=32).to_dict(),
    "phi3": lambda: transformers.Phi3Config(
        **{**TINY, "hidden_size": 192, "num_attention_heads": 2,
           "num_key_value_heads": 2}, pad_token_id=0).to_dict(),
    "phi3_longrope": lambda: _longrope_cfg_dict(False),
    "phi3_su_partial": lambda: _longrope_cfg_dict(True),
    "gemma": lambda: transformers.GemmaConfig(
        **TINY, head_dim=32, hidden_act="gelu").to_dict(),
    "gemma_activation": lambda: {**transformers.GemmaConfig(
        **TINY, head_dim=32).to_dict(), "hidden_act": None,
        "hidden_activation": "gelu_pytorch_tanh"},
    "aquila": lambda: {**transformers.LlamaConfig(**TINY).to_dict(),
                       "model_type": "aquila"},
    "llama3": lambda: transformers.LlamaConfig(
        **TINY, rope_scaling={"rope_type": "llama3", "factor": 8.0,
                              "low_freq_factor": 1.0,
                              "high_freq_factor": 4.0,
                              "original_max_position_embeddings": 32},
    ).to_dict(),
    "llama_linear": lambda: transformers.LlamaConfig(
        **TINY, rope_scaling={"rope_type": "linear", "factor": 2.0}
    ).to_dict(),
}


def _longrope_cfg_dict(partial):
    n = 6 if partial else 8          # rotary_dim / 2 factors, head_dim 16
    return transformers.Phi3Config(
        **TINY, original_max_position_embeddings=64, pad_token_id=0,
        **({"partial_rotary_factor": 0.75} if partial else {}),
        rope_scaling={"type": "su" if partial else "longrope",
                      "short_factor": [1.0 + 0.2 * i for i in range(n)],
                      "long_factor": [2.0 + 0.4 * i for i in range(n)]},
    ).to_dict()


@pytest.mark.parametrize("family", list(HF_CONFIGS))
def test_config_from_hf_as_jax(family):
    d = HF_CONFIGS[family]()
    j, t = jhf.config_from_hf(d), thf.config_from_hf(d)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    want = {"qwen2_g7": ("qwen2", 7), "phi3": ("phi3", 1)}.get(family)
    if want:
        assert (t.model_type, t.num_attention_heads
                // t.num_key_value_heads) == want
    if family == "phi3":
        assert t.head_dim_ == 96
    if family == "phi3_su_partial":
        assert t.rotary_dim == 12 and t.rope_scaling_type == "longrope"
    if family.startswith("qwen2") and family != "qwen2_window":
        assert t.attention_bias and t.sliding_window is None


@pytest.mark.parametrize("rtype", ["yarn", "dynamic"])
def test_other_rope_scalings_raise_value_error(rtype):
    d = {**HF_CONFIGS["qwen2"](),
         "rope_scaling": {"rope_type": rtype, "factor": 4.0}}
    with pytest.raises(ValueError):
        jhf.config_from_hf(d)
    with pytest.raises(ValueError, match="rope_scaling"):
        thf.config_from_hf(d)


# the published config.json fields of each preset (the fields config_from_hf
# reads), as the preset's docstring names its source
PUBLISHED = {
    "llama31_8b": dict(
        model_type="llama", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0, hidden_act="silu", attention_bias=False,
        tie_word_embeddings=False,
        rope_scaling={"factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192,
                      "rope_type": "llama3"}),
    "qwen25_7b": dict(
        model_type="qwen2", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=131072, rms_norm_eps=1e-6,
        rope_theta=1000000.0, sliding_window=131072,
        use_sliding_window=False, tie_word_embeddings=False),
    "qwen3_8b": dict(
        model_type="qwen3", vocab_size=151936, hidden_size=4096,
        intermediate_size=12288, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        max_position_embeddings=40960, rms_norm_eps=1e-6, rope_theta=1000000,
        rope_scaling=None, attention_bias=False, use_sliding_window=False,
        sliding_window=None, tie_word_embeddings=False),
    "phi3_mini_4k": dict(
        model_type="phi3", vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096, original_max_position_embeddings=4096,
        rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
        sliding_window=2047, tie_word_embeddings=False),
    "gemma_7b": dict(
        model_type="gemma", vocab_size=256000, hidden_size=3072,
        intermediate_size=24576, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=16, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
        rope_scaling=None, hidden_act="gelu"),
}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_presets_are_jax_configs_of_the_published(name):
    got = getattr(presets, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jhf.config_from_hf(PUBLISHED[name]))
    tdecoder._check_supported(got)
    assert got.num_attention_heads // got.num_key_value_heads in (1, 4, 7)
