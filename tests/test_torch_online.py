"""PyTorch port: the online outlier predictor end to end against
mixq_tpu/quantize/online.py on tests/test_online.py's outlier model (a
tiny llama whose embedding channel 7 is boosted by 10), W8A8 MIX with a
budget of 16:

- warmup_online_outliers: after each of two warmup batches the sets,
  counts and every promoted parameter equal JAX's bit for bit. JAX runs
  its stats forward under jit, the port eagerly; the test asserts that
  every channel's maximum lies farther from sigma than the two stats
  forwards differ, so no channel sits where that spread could move it.
  The second batch adds no channel there (asserted), so JAX's loss of
  earlier w_outlier rows at a second promotion
  (tests/test_torch_online_detect.py) does not enter;
- a low sigma fills sets to their budget and stops there;
- InferenceEngine.warmup_online, then generate: the same counts and the
  same greedy tokens as JAX's engine after its warmup_online. Replayed
  teacher-forced on both engines, every step's top-2 logit margin is
  asserted larger than twice the largest logit difference between them
  (JAX's engine runs under jit), so no near-tie decides a token."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mixq_tpu.config import EngineConfig as JEngineConfig
from mixq_tpu.config import QuantConfig
from mixq_tpu.engine import InferenceEngine as JEngine
from mixq_tpu.models import KVCache as JKVCache
from mixq_tpu.models.decoder import forward as j_forward
from mixq_tpu.quantize import quantize_model as j_quantize_model
from mixq_tpu.quantize.online import warmup_online_outliers as j_warmup
from mixq_tpu_torch.config import EngineConfig, ModelConfig
from mixq_tpu_torch.config import QuantConfig as TQuantConfig
from mixq_tpu_torch.engine import InferenceEngine
from mixq_tpu_torch.models.hf import TensorSource
from mixq_tpu_torch.quantize import quantize_model, warmup_online_outliers
from test_online import outlier_model
from test_torch_hf_source import assert_tree_equal

BUDGET, SIGMA = 16, 6.0
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11, 12, 13], [42]]
NEW = 6


def both_models(budget=BUDGET):
    cfg, src = outlier_model()
    qcfg = QuantConfig.w8a8(outlier_budget=budget)
    jp, jspecs = j_quantize_model(src, cfg, qcfg)
    tp, tspecs = quantize_model(
        TensorSource.from_dict(src.d), ModelConfig.from_dict(cfg.to_dict()),
        TQuantConfig.from_dict(qcfg.to_dict()), device="cpu")
    return cfg, jp, jspecs, tp, tspecs


def warm_batches(cfg):
    return [np.random.RandomState(s).randint(0, cfg.vocab_size, (2, 16))
            for s in range(2)]


def j_stats(jp, jspecs, cfg, batch):
    """JAX's stats forward, jitted, as its warmup runs it."""
    fn = jax.jit(lambda p, t, c: j_forward(p, t, c, jspecs, cfg,
                                           collect_stats=True)[2])
    cache = JKVCache.create(cfg.num_hidden_layers, batch.shape[0],
                            batch.shape[1], cfg.num_key_value_heads,
                            cfg.head_dim_, jnp.bfloat16)
    return {k: np.asarray(v) for k, v in
            fn(jp, jnp.asarray(batch, jnp.int32), cache).items()}


def test_warmup_sets_and_params_as_jax():
    cfg, jp, jspecs, tp, tspecs = both_models()
    batches = warm_batches(cfg)
    tcfg = ModelConfig.from_dict(cfg.to_dict())
    counts = []
    for step in (1, 2):
        log = []
        tw, tc = warmup_online_outliers(tp, tcfg, tspecs, batches,
                                        sigma=SIGMA, max_steps=step,
                                        stats_log=log)
        jw, jc = j_warmup(jp, cfg, jspecs, batches, sigma=SIGMA,
                          max_steps=step)
        assert tc == jc
        assert_tree_equal(jax.tree.map(np.asarray, jw), tw)
        counts.append(tc)
        # the margin: the last step's stats, on both sides from the same
        # (step - 1)-warmed params
        jprev = j_warmup(jp, cfg, jspecs, batches, sigma=SIGMA,
                         max_steps=step - 1)[0] if step > 1 else jp
        js = j_stats(jprev, jspecs, cfg, batches[step - 1])
        spread = max(np.abs(log[-1][k].numpy() - js[k]).max() for k in js)
        margin = min(np.abs(log[-1][k].numpy() - SIGMA).min() for k in js)
        assert margin > spread, (step, margin, spread)
    assert sum(counts[0].values()) > 0
    assert counts[1] == counts[0]          # the second batch adds none
    wq = tw.blocks[0].attn.wq
    assert 7 in wq.out_ind[:int(wq.out_count)].tolist()


def test_low_sigma_fills_and_caps():
    cfg, jp, jspecs, tp, tspecs = both_models(budget=4)
    tcfg = ModelConfig.from_dict(cfg.to_dict())
    _, counts = warmup_online_outliers(tp, tcfg, tspecs, warm_batches(cfg),
                                       sigma=0.5)
    assert max(counts.values()) == 4 and min(counts.values()) >= 1


def test_engine_warmup_then_generate_as_jax():
    cfg, jp, jspecs, tp, tspecs = both_models()
    ecfg = dict(max_seq_len=64, prefill_chunk=8)
    jeng = JEngine(jp, cfg, jspecs, JEngineConfig(**ecfg))
    eng = InferenceEngine(tp, ModelConfig.from_dict(cfg.to_dict()), tspecs,
                          EngineConfig(**ecfg), device="cpu")
    head = eng.head_f32
    batches = warm_batches(cfg)
    assert eng.warmup_online(batches) == jeng.warmup_online(batches)
    assert eng.head_f32 is head and eng.params is not tp
    ref = jeng.generate(PROMPTS, NEW)
    got = eng.generate(PROMPTS, NEW)
    assert got == ref
    # no near-ties: replay the greedy run teacher-forced on both engines;
    # at every step the port's top-2 margin exceeds twice the largest
    # logit difference between the two, so the argmax cannot differ
    toks = np.asarray(got)
    Tp = 8
    padded = np.zeros((len(PROMPTS), Tp), np.int32)
    kv_start = np.array([Tp - len(p) for p in PROMPTS], np.int32)
    for i, p in enumerate(PROMPTS):
        padded[i, Tp - len(p):] = p
    cache = eng.new_cache(len(PROMPTS), 128)
    jcache = jeng.new_cache(len(PROMPTS), 128)
    logits, cache = eng.prefill(padded, cache, kv_start)
    jlogits, jcache = jeng.prefill(jnp.asarray(padded), jcache,
                                   jnp.asarray(kv_start))
    for step in range(NEW):
        top2 = torch.topk(logits, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        diff = np.abs(logits.numpy() - np.asarray(jlogits)).max()
        assert margin > 2 * diff, (step, margin, diff)
        if step + 1 < NEW:
            nxt = toks[:, step:step + 1]
            logits, cache = eng.decode_step(nxt, cache, kv_start)
            jlogits, jcache = jeng.decode_step(jnp.asarray(nxt), jcache,
                                               jnp.asarray(kv_start))
