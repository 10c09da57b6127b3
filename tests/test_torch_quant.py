"""PyTorch port: config JSON round-trips across the two packages, and the
ported quantization primitives are bit-equal to mixq_tpu/ops/quant.py on
random inputs, planted-outlier inputs and exact .5 ties (jnp.round and
torch.round both round half to even)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu import config as jcfg
from mixq_tpu.ops import quant as JQ
from mixq_tpu_torch import config as tcfg
from mixq_tpu_torch.ops import quant as TQ


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def assert_same(j, p):
    """Same dtype, shape and bits (bf16 compared through exact f32)."""
    j = np.asarray(j)
    if p.dtype == torch.bfloat16:
        assert j.dtype.name == "bfloat16", j.dtype
        j, p = j.astype(np.float32), p.float().numpy()
    else:
        p = p.numpy()
        assert j.dtype == p.dtype, (j.dtype, p.dtype)
    assert j.shape == p.shape, (j.shape, p.shape)
    np.testing.assert_array_equal(j, p)


@pytest.mark.parametrize("make", ["tiny", "w8a8", "quik", "engine"])
def test_config_json_roundtrip(make):
    if make == "engine":
        for a, b in ((jcfg, tcfg), (tcfg, jcfg)):
            e = a.EngineConfig(max_batch_size=3, kv_dtype="int8",
                               mesh_shape=(2, 4))
            d = json.loads(json.dumps(e.to_dict()))
            assert b.EngineConfig(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in d.items()}
                                  ).to_dict() == e.to_dict()
        return
    for a, b in ((jcfg, tcfg), (tcfg, jcfg)):
        if make == "tiny":
            c = a.ModelConfig.tiny(num_key_value_heads=1, rope_theta=5e5,
                                   rope_long_factor=(1.0, 2.0))
            back = b.ModelConfig.from_dict(json.loads(json.dumps(c.to_dict())))
        else:
            c = (a.QuantConfig.w8a8(outlier_budget=64) if make == "w8a8"
                 else a.QuantConfig.quik_w4a4())
            back = b.QuantConfig.from_dict(json.loads(json.dumps(c.to_dict())))
        assert back.to_dict() == c.to_dict()
        assert type(back).__module__ == b.__name__


def _inputs(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    if kind == "outliers":
        cols = rng.choice(shape[-1], 4, replace=False)
        x[..., cols] *= 60.0
    elif kind == "ties":
        # scale = 127 / 127 = 1 per row (max |x| = 127), so x / scale lands
        # exactly on k + 0.5 and round-half-even decides
        x = np.round(x * 20) + 0.5
        x[..., 0] = 127.0
    return x


@pytest.mark.parametrize("kind", ["random", "outliers", "ties"])
def test_quantize_weight_int8(kind):
    w = _inputs(kind, (40, 96), 0).T.copy()      # [K=96, N=40]
    jq, js = JQ.quantize_weight_int8(jnp.asarray(w))
    tq, ts = TQ.quantize_weight_int8(t(w))
    assert_same(jq, tq)
    assert_same(js, ts)


@pytest.mark.parametrize("kind", ["random", "outliers", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_act_per_token(kind, dtype):
    x = _inputs(kind, (5, 7, 64), 1)
    jx = jnp.asarray(x).astype(dtype)
    tx = t(x).to(getattr(torch, dtype))
    for bits in (8, 4):
        jq, js = JQ.quantize_act_per_token(jx, bits=bits)
        tq, ts = TQ.quantize_act_per_token(tx, bits=bits)
        assert_same(jq, tq)
        assert_same(js, ts)
    if kind == "ties" and dtype == "float32":
        tq, _ = TQ.quantize_act_per_token(tx)
        assert (tq.float() - tx).abs().max() == 0.5   # ties were exercised


@pytest.mark.parametrize("kind", ["random", "outliers", "ties"])
def test_quantize_kv(kind):
    x = _inputs(kind, (2, 6, 3, 32), 2)
    jq, js = JQ.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16))
    tq, ts = TQ.quantize_kv(t(x).to(torch.bfloat16))
    assert_same(jq, tq)
    assert_same(js, ts)


def test_outlier_set_and_helpers():
    rng = np.random.default_rng(3)
    K, N, budget = 48, 20, 8
    ind = np.sort(rng.choice(K, 5, replace=False))
    js = JQ.outlier_set_from_indices(ind, K, budget)
    ts = TQ.outlier_set_from_indices(ind, K, budget, device="cpu")
    for a, b in zip(js, ts):
        assert_same(a, b)
    assert ts.budget == budget
    je, te = JQ.empty_outlier_set(K, budget), TQ.empty_outlier_set(
        K, budget, device="cpu")
    for a, b in zip(je, te):
        assert_same(a, b)
    x = rng.normal(0, 1, (3, 4, K)).astype(np.float32)
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    for dt in (jnp.float32, jnp.bfloat16):
        tdt = torch.float32 if dt == jnp.float32 else torch.bfloat16
        assert_same(JQ.extract_outliers(jnp.asarray(x).astype(dt), js),
                    TQ.extract_outliers(t(x).to(tdt), ts))
        assert_same(JQ.mask_inliers(jnp.asarray(x).astype(dt), js),
                    TQ.mask_inliers(t(x).to(tdt), ts))
        assert_same(JQ.gather_outlier_weights(jnp.asarray(w).astype(dt), js),
                    TQ.gather_outlier_weights(t(w).to(tdt), ts))
    scales = rng.permutation(K).astype(np.float32)
    jt = JQ.top_k_outliers_from_scales(jnp.asarray(scales), 6, K, budget)
    tt = TQ.top_k_outliers_from_scales(t(scales), 6, K, budget)
    for a, b in zip(jt, tt):
        assert_same(a, b)


def test_dequant_epilogue():
    rng = np.random.default_rng(4)
    acc = rng.integers(-2**20, 2**20, (6, 10)).astype(np.int32)
    xs = rng.uniform(0.01, 0.1, (6, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (10,)).astype(np.float32)
    op = rng.normal(0, 1, (6, 10)).astype(np.float32)
    for outlier in (None, op):
        j = JQ.dequant_epilogue(jnp.asarray(acc), jnp.asarray(xs),
                                jnp.asarray(ws),
                                None if outlier is None else jnp.asarray(outlier),
                                jnp.float32)
        p = TQ.dequant_epilogue(t(acc), t(xs), t(ws),
                                None if outlier is None else t(outlier),
                                torch.float32)
        assert_same(j, p)


@pytest.mark.parametrize("kind", ["random", "outliers", "ties"])
def test_quantize_weight_int4_and_packing(kind):
    """int4 quantization, and halves-layout packing of its values (and of
    every int4 value at every position), bit-equal to JAX both ways."""
    w = _inputs(kind, (40, 96), 5).T.copy()      # [K=96, N=40]
    jq, js = JQ.quantize_weight_int4(jnp.asarray(w))
    tq, ts = TQ.quantize_weight_int4(t(w))
    assert_same(jq, tq)
    assert_same(js, ts)
    every = np.tile(np.arange(-8, 8, dtype=np.int8), (8, 3))   # [8, 48]
    for q in (np.asarray(jq), every.T.copy()):
        jp, tp = JQ.pack_int4(jnp.asarray(q)), TQ.pack_int4(t(q))
        assert_same(jp, tp)
        assert_same(JQ.unpack_int4(jp), TQ.unpack_int4(tp))
        assert_same(q, TQ.unpack_int4(tp))
    # the halves layout: row k in the low nibble, row k + K/2 in the high
    q = np.asarray(jq)
    tp = TQ.pack_int4(t(q)).numpy()
    assert (tp & 0x0F == q[:48] & 0x0F).all()
    assert (tp >> 4 == q[48:] & 0x0F).all()


@pytest.mark.parametrize("bits,group", [(4, 32), (8, 16), (4, 48)])
@pytest.mark.parametrize("kind", ["random", "outliers", "ties"])
def test_quantize_weight_grouped(bits, group, kind):
    w = _inputs(kind, (24, 96), 6).T.copy()      # [K=96, N=24]
    jq, js = JQ.quantize_weight_grouped(jnp.asarray(w), bits, group)
    tq, ts = TQ.quantize_weight_grouped(t(w), bits, group)
    assert_same(jq, tq)
    assert_same(js, ts)
    assert tuple(ts.shape) == (96 // group, 24)


def test_grouped_int8_matmul_dequant():
    """f32 within 2 ulps of |y|: the integer group sums are exact on both
    sides; only the f32 sum over groups may pair terms in another order."""
    rng = np.random.default_rng(7)
    M, K, N, G = 5, 128, 24, 4
    q_x = rng.integers(-127, 128, (M, K)).astype(np.int8)
    q_w = rng.integers(-8, 8, (K, N)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, (G, N)).astype(np.float32)
    j = np.asarray(JQ.grouped_int8_matmul_dequant(
        jnp.asarray(q_x), jnp.asarray(xs), jnp.asarray(q_w), jnp.asarray(ws)))
    p = TQ.grouped_int8_matmul_dequant(t(q_x), t(xs), t(q_w), t(ws)).numpy()
    assert p.dtype == np.float32
    np.testing.assert_allclose(p, j, rtol=2 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("make", ["w8a8", "w4a4", "w4a4_g128", "w8a16",
                                  "fp16", "quik", "gptj_w4a4"])
def test_resolve_specs_matches_jax(make):
    """Every slot's LinearSpec equal, field for field, to JAX's policy
    (apply_arch_policy first, as quantize_model does)."""
    import dataclasses

    from mixq_tpu.quantize import quantizer as JQZ
    from mixq_tpu_torch.quantize import quantizer as TQZ

    arch = "gptj" if make.startswith("gptj") else "llama"
    specs = []
    for mod, cfgmod in ((JQZ, jcfg), (TQZ, tcfg)):
        QC = cfgmod.QuantConfig
        q = {"w8a8": QC.w8a8(), "w4a4": QC.w4a4(),
             "w4a4_g128": QC.w4a4(q_group_size=128), "w8a16": QC.w8a16(),
             "fp16": QC.fp16(), "quik": QC.quik_w4a4(),
             "gptj_w4a4": QC.w4a4()}[make]
        specs.append(mod.resolve_specs(mod.apply_arch_policy(q, arch)))
    for slot in ("wqkv", "wo", "up", "gate", "down"):
        assert (dataclasses.asdict(getattr(specs[0], slot))
                == dataclasses.asdict(getattr(specs[1], slot))), slot
    for mod, cfgmod in ((JQZ, jcfg), (TQZ, tcfg)):
        with pytest.raises(ValueError):
            mod.resolve_specs(cfgmod.QuantConfig.quik_w4a4(q_group_size=64))
