"""PyTorch port, perplexity (mixq_tpu_torch/eval/perplexity.py) against
JAX's compute_perplexity (mixq_tpu/eval/perplexity.py), and the tiny
trained-substrate gate (examples/realistic_gate_torch.py) at smoke size.

The same tiny model (tests/test_torch_models.py: FP16, W8A8O16 and
W4A4O16 with planted outlier channels, carried bit for bit) and the same
random tokens go through both, with bf16 and int8 KV. The port holds
JAX's eager path (jax.disable_jit()) within 1e-4 relative in PPL and NLL:
the quantized models match it to ~1e-7 in logits, and the FP16 model's
bf16 activations can flip a rounding where a sum runs in another order
(its logits within tests/test_torch_decoder.py's 5e-3 max|logits|; its
PPL measured 2.5e-5 apart). JAX's jitted path is held only within its own
jit-vs-eager spread, measured in the same test, plus that 1e-4
(ROADMAP.md Queue C: the spread reaches 8.5e-2 max|logits| on tiny
W4A4). JAX's own cases hold on the port: batch-size invariance (1e-3, its
limit), max_windows, the "need at least n_ctx tokens" ValueError and BOS
substitution. The gate's run at --steps 40 --segments 2 (and JAX's
TestTraining batch and corpus, 8 x 64 of 20,000 tokens, with 4 windows
of 64 a segment) gives JAX's row kinds and keys."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.eval import compute_perplexity as j_compute_perplexity
from mixq_tpu_torch.eval import compute_perplexity
from mixq_tpu_torch.eval.perplexity import window_nll
from mixq_tpu_torch.models.decoder import lm_head_f32

import test_torch_models as models

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts six workers on the cores,
    and small ops split over every core then wait on each other (the
    training steps ran ~60x slower that way)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
N_CTX, WINDOWS, BATCH = 32, 6, 4


@pytest.fixture(scope="module")
def tokens():
    return np.random.RandomState(0).randint(
        0, models.tiny_cfg().vocab_size, N_CTX * WINDOWS + 5)


def _build(config):
    if config == "fp16":
        return models.build(seed=1, quantized=False)
    return models.build(seed=1, qcfg=models.CONFIGS.get(config))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("config", ["fp16", "w8a8", "w4a4"])
def test_ppl_equals_jax_eager(config, kv, tokens):
    cfg, jp, jspecs, tp, tspecs = _build(config)
    got = compute_perplexity(tp, cfg, tokens, tspecs, n_ctx=N_CTX,
                             batch_size=BATCH, kv_dtype=kv)
    with jax.disable_jit():
        want = j_compute_perplexity(jp, cfg, tokens, jspecs, n_ctx=N_CTX,
                                    batch_size=BATCH,
                                    kv_dtype=jnp.dtype(kv))
    assert (got.n_windows, got.n_tokens) == (want.n_windows, want.n_tokens)
    assert got.n_windows == WINDOWS
    assert got.ppl == pytest.approx(want.ppl, rel=TOL)
    assert got.nll == pytest.approx(want.nll, rel=TOL)


def test_ppl_within_jax_jit_spread(tokens):
    """W4A4O16 with int8 KV, where JAX's jitted path moves most."""
    cfg, jp, jspecs, tp, tspecs = _build("w4a4")
    args = dict(n_ctx=N_CTX, batch_size=BATCH)
    got = compute_perplexity(tp, cfg, tokens, tspecs, kv_dtype="int8",
                             **args).ppl
    jit = j_compute_perplexity(jp, cfg, tokens, jspecs,
                               kv_dtype=jnp.int8, **args).ppl
    with jax.disable_jit():
        eager = j_compute_perplexity(jp, cfg, tokens, jspecs,
                                     kv_dtype=jnp.int8, **args).ppl
    assert abs(got - jit) <= abs(jit - eager) + TOL * eager


def test_batch_size_invariance_max_windows_and_errors(tokens):
    cfg, _, _, tp, tspecs = _build("w8a8")
    r1 = compute_perplexity(tp, cfg, tokens, tspecs, n_ctx=N_CTX,
                            batch_size=3)
    r2 = compute_perplexity(tp, cfg, tokens, tspecs, n_ctx=N_CTX,
                            batch_size=16)
    assert r1.ppl > 1.0 and np.isfinite(r1.ppl)
    assert abs(r1.ppl - r2.ppl) / r1.ppl < 1e-3
    r = compute_perplexity(tp, cfg, tokens, tspecs, n_ctx=N_CTX,
                           batch_size=4, max_windows=4)
    assert r.n_windows == 4 and r.n_tokens == 4 * (N_CTX // 2)
    assert "windows=4" in repr(r)
    with pytest.raises(ValueError, match="need at least"):
        compute_perplexity(tp, cfg, tokens[:N_CTX - 1], tspecs, n_ctx=N_CTX)


def test_bos_substitution_and_second_half(tokens):
    """A window's NLL counts only targets t + 1 >= n_ctx / 2, and its first
    token is BOS whatever the stream holds there."""
    cfg, _, _, tp, tspecs = _build("fp16")
    a = tokens[:N_CTX].copy()
    b = a.copy()
    b[0] = (a[0] + 7) % cfg.vocab_size          # replaced by BOS anyway
    ra = compute_perplexity(tp, cfg, a, tspecs, n_ctx=N_CTX)
    rb = compute_perplexity(tp, cfg, b, tspecs, n_ctx=N_CTX)
    assert ra.nll == rb.nll
    w = torch.from_numpy(a[None].astype(np.int64))
    w[0, 0] = 1
    with torch.inference_mode():
        nll = window_nll(tp, w, tspecs, cfg, "bfloat16",
                         lm_head_f32(tp, tspecs))
    assert float(nll[0]) == pytest.approx(ra.nll, rel=1e-6)


def test_tiny_gate_run_gives_jax_rows():
    """examples/realistic_gate_torch.run on the CPU at smoke size: the rows
    of examples/realistic_gate.py (planting, convergence, a row per config
    and KV type with paired deltas, the monotone gate) plus the training
    row and mix8_warmed."""
    import realistic_gate_torch as gate

    args = gate.parser().parse_args([
        "--device", "cpu", "--steps", "40", "--segments", "2",
        "--train_batch", "8", "--seq_len", "64", "--windows", "4",
        "--n_ctx", "64", "--corpus_tokens", "20000"])
    seen = []
    rows = gate.run(args, on_config=lambda name, params, specs, segs:
                    seen.append((name, len(segs))))
    checks = [r["check"] for r in rows if "check" in r]
    assert checks == ["train_tiny_lm", "plant_function_preserving",
                      "online_predictor_convergence", "monotone_separation"]
    assert rows[0]["loss"] < rows[0]["chance"]
    assert rows[1]["drift"] < 0.02
    cells = {(r["config"], r["kv"]): r for r in rows if "config" in r}
    names = ["fp16", "mix8", "mix4", "mix4_g64", "mix4_full_g64", "quik",
             "mix8_warmed"]
    assert sorted(cells) == sorted((n, kv) for n in names
                                   for kv in ("bfloat16", "int8"))
    assert seen == [(n, 2) for n in names]
    for r in cells.values():
        assert {"ppl_mean", "ppl_std", "segments", "windows", "preset",
                "seconds", "delta_vs_fp16", "delta_std_paired",
                "rel_delta_pct"} <= set(r)
        assert np.isfinite(r["ppl_mean"]) and r["segments"] == 2
    assert cells[("fp16", "bfloat16")]["delta_vs_fp16"] == 0.0
    gate_row = rows[-1]
    assert {"fp16_ppl", "mix8_delta", "mix4_delta", "paired_band_2se",
            "monotone", "mix4_gap_significant"} <= set(gate_row)
