"""PyTorch port, the lm-eval adaptor (mixq_tpu_torch/eval/lm_eval_adaptor.py),
its offline tasks (eval/offline_tasks.py) and MMLU (eval/mmlu.py) against
JAX's (mixq_tpu/eval/).

MixQLM._score on the tiny W8A8O16 model (tests/test_torch_models.py,
carried bit for bit): against a direct forward of the port (1e-4, JAX's
limit in tests/test_lm_eval.py) and against JAX's MixQLM._score on the
same pairs on its eager path (jax.disable_jit(); logprobs within 1e-4,
greedy flags equal; JAX's jitted path sits up to 7.4e-3 away here, its
own jit-vs-eager spread), batched against single (1e-3, JAX's), and the
clamp of a continuation that fills the window. The harness calls on it
(loglikelihood, loglikelihood_rolling, generate_until). The offline task
builders give JAX's items, and cloze and completion score >= 0.9 through
the adaptor on the tiny Markov LM, as in JAX. evaluate_mmlu on JAX's
char tokenizer and synthetic CSVs (tests/test_mmlu.py) gives JAX's
result, per subject, on the same FP16 model."""
import csv

import jax
import numpy as np
import pytest
import torch

from mixq_tpu.eval import offline_tasks as JT
from mixq_tpu.eval.lm_eval_adaptor import MixQLM as JMixQLM
from mixq_tpu.eval.mmlu import evaluate_mmlu as j_evaluate_mmlu
from mixq_tpu.eval.mmlu import format_example as j_format_example
from mixq_tpu.eval.mmlu import gen_prompt as j_gen_prompt
from mixq_tpu_torch.config import ModelConfig
from mixq_tpu_torch.eval import offline_tasks as TT
from mixq_tpu_torch.eval.lm_eval_adaptor import MixQLM
from mixq_tpu_torch.eval.mmlu import (MMLUResult, evaluate_mmlu,
                                      format_example, gen_prompt)
from mixq_tpu_torch.models import DecoderSpecs, KVCache
from mixq_tpu_torch.models.decoder import forward, lm_head_f32
from mixq_tpu_torch.models.hf import params_from_source
from mixq_tpu_torch.utils.substrate import make_markov_state
from mixq_tpu_torch.utils.testing import DictSource

import test_torch_models as models


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts six workers on the cores,
    and small ops split over every core then wait on each other (the
    training steps ran ~60x slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class CharTok:
    """Character-level tokenizer (ids = bytes mod vocab), tests/
    test_lm_eval.py's FakeTok."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab):
        self.vocab = vocab

    def __call__(self, text, add_special_tokens=True):
        class R:
            pass

        r = R()
        r.input_ids = [3 + (b % (self.vocab - 3)) for b in text.encode()]
        if add_special_tokens:
            r.input_ids = [self.bos_token_id] + r.input_ids
        return r

    def decode(self, ids):
        return " ".join(map(str, ids))


class Req:
    def __init__(self, *args):
        self.args = args


@pytest.fixture(scope="module")
def tiny():
    cfg, jp, jspecs, tp, tspecs = models.build(seed=2)
    tok = CharTok(cfg.vocab_size)
    return (MixQLM(tp, cfg, tspecs, tok, batch_size=4, max_length=64),
            JMixQLM(jp, cfg, jspecs, tok, batch_size=4, max_length=64))


PAIRS = [([1, 5, 9, 4], [7, 3]), ([1, 8], [4, 4, 6]), ([1], [9, 9]),
         ([1, 30, 31, 32, 33, 34], [35])]


def test_score_matches_direct_forward(tiny):
    lm, _ = tiny
    ctx, cont = [1, 5, 9, 4], [7, 3]
    (lp, greedy), = lm._score([(ctx, cont)])
    ids = ctx + cont
    cfg = lm.cfg
    cache = KVCache.create(cfg.num_hidden_layers, 1, len(ids),
                           cfg.num_key_value_heads, cfg.head_dim_,
                           torch.bfloat16, device="cpu")
    with torch.inference_mode():
        logits, _ = forward(lm.params, torch.tensor([ids]), cache, lm.specs,
                            cfg, torch.zeros(1, dtype=torch.int32),
                            head_f32=lm_head_f32(lm.params, lm.specs))
    logp = torch.log_softmax(logits.float(), -1)[0].numpy()
    want = sum(float(logp[t - 1, ids[t]]) for t in range(len(ctx), len(ids)))
    assert lp == pytest.approx(want, rel=1e-4, abs=1e-4)
    assert greedy == all(int(np.argmax(logp[t - 1])) == ids[t]
                         for t in range(len(ctx), len(ids)))


def test_score_equals_jax(tiny):
    lm, jlm = tiny
    with jax.disable_jit():
        want = jlm._score(PAIRS)
    for (lp, g), (jlp, jg) in zip(lm._score(PAIRS), want):
        assert lp == pytest.approx(jlp, abs=1e-4)
        assert g == jg


def test_batched_scores_match_single_and_clamp(tiny):
    lm, _ = tiny
    for pair, (lp, g) in zip(PAIRS, lm._score(PAIRS)):
        (lp1, g1), = lm._score([pair])
        assert lp == pytest.approx(lp1, rel=1e-3, abs=1e-3)
        assert g == g1
    # a continuation longer than max_length: cut from the left, its first
    # slot (no predicting position) dropped
    (lp, _), = lm._score([([1], [5] * (lm.max_length + 8))])
    assert np.isfinite(lp)


def test_harness_api(tiny):
    lm, _ = tiny
    out = lm.loglikelihood([Req("abc", " d"), Req("", " xy")])
    assert len(out) == 2
    assert all(np.isfinite(lp) and isinstance(g, (bool, np.bool_))
               for lp, g in out)
    roll = lm.loglikelihood_rolling([Req("hello world")])
    assert len(roll) == 1 and np.isfinite(roll[0])
    gen = lm.generate_until([Req("ab", {"max_gen_toks": 4})])
    assert len(gen) == 1 and len(gen[0].split()) == 4


def test_task_builders_equal_jax():
    corpus = np.random.RandomState(3).randint(2, 300, 500).astype(np.int32)
    assert (TT.build_cloze_task(corpus, n_items=6, ctx_len=8, cont_len=3)
            == JT.build_cloze_task(corpus, n_items=6, ctx_len=8,
                                   cont_len=3))
    assert (TT.build_completion_task(corpus, n_items=5, ctx_len=8,
                                     gen_len=3)
            == JT.build_completion_task(corpus, n_items=5, ctx_len=8,
                                        gen_len=3))
    tok = TT.IntTokenizer()
    assert tok("4 5 6").input_ids == JT.IntTokenizer()("4 5 6").input_ids
    assert tok.decode([4, 5]) == "4 5"


@pytest.fixture(scope="module")
def markov_lm():
    """tests/test_lm_eval.py's Markov LM through the port."""
    cfg = ModelConfig(model_type="llama", vocab_size=512, hidden_size=256,
                      intermediate_size=704, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=4)
    state, succ = make_markov_state(cfg, v_eff=128, seed=0, mean_cycle=12)
    specs = DecoderSpecs.fp16()
    params = params_from_source(DictSource(state), cfg, specs, device="cpu")
    lm = MixQLM(params, cfg, specs, TT.IntTokenizer(), batch_size=8,
                max_length=64)
    walk = [5]
    for _ in range(400):
        walk.append(int(succ[walk[-1]]))
    return lm, np.asarray(walk, np.int32)


def test_cloze_loglikelihood_path(markov_lm):
    lm, corpus = markov_lm
    items = TT.build_cloze_task(corpus, n_items=16, ctx_len=8, cont_len=3)
    res = TT.evaluate_cloze(lm, items)
    assert res["acc"] >= 0.9, res


def test_completion_generate_path(markov_lm):
    lm, corpus = markov_lm
    items = TT.build_completion_task(corpus, n_items=8, ctx_len=8, gen_len=3)
    res = TT.evaluate_completion(lm, items)
    assert res["exact_match"] >= 0.9, res


class MMLUTok:
    """tests/test_mmlu.py's char tokenizer over a tiny vocab."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, text, add_special_tokens=True):
        ids = [min(ord(c), self.vocab_size - 1) for c in text]

        class R:
            input_ids = ids
        return R()


@pytest.fixture()
def data_dir(tmp_path):
    """tests/test_mmlu.py's synthetic Hendrycks-format data."""
    for split, n in (("dev", 5), ("test", 6)):
        d = tmp_path / split
        d.mkdir()
        for subject in ("algebra", "biology"):
            with open(d / f"{subject}_{split}.csv", "w", newline="") as f:
                w = csv.writer(f)
                for i in range(n):
                    w.writerow([f"Question {i}?", "one", "two", "three",
                                "four", "ABCD"[i % 4]])
    return str(tmp_path)


def test_prompts_equal_jax():
    row = ["Q?", "a1", "a2", "a3", "a4", "B"]
    assert format_example(row) == j_format_example(row)
    assert (format_example(row, include_answer=False)
            == j_format_example(row, include_answer=False))
    rows = [["Q%d" % i, "a", "b", "c", "d", "A"] for i in range(5)]
    assert gen_prompt(rows, "abstract_algebra", 2) == j_gen_prompt(
        rows, "abstract_algebra", 2)


@pytest.mark.parametrize("n_shot,limits", [
    (2, {}), (1, dict(max_subjects=1, max_questions_per_subject=3)),
    (5, dict(max_seq=200))])
def test_evaluate_mmlu_equals_jax(data_dir, n_shot, limits):
    """The FP16 model with 2 shots, with the subject and question limits,
    and with a budget that makes the prompts drop shots."""
    cfg, jp, jspecs, tp, tspecs = models.build(seed=3, quantized=False)
    tok = MMLUTok(cfg.vocab_size)
    kw = dict(n_shot=n_shot, max_seq=limits.pop("max_seq", 1024), **limits)
    got = evaluate_mmlu(tp, cfg, tspecs, tok, data_dir, **kw)
    want = j_evaluate_mmlu(jp, cfg, jspecs, tok, data_dir, **kw)
    assert isinstance(got, MMLUResult)
    assert got.n_questions == want.n_questions
    assert got.per_subject == want.per_subject
    assert got.accuracy == want.accuracy
    assert 0.0 <= got.accuracy <= 1.0
