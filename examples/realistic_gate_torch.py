"""The trained-substrate accuracy gate on the PyTorch port (mirrors
examples/realistic_gate.py).

A tiny LM is trained on a synthetic language (mixq_tpu_torch/utils/
substrate.py) until its perplexity is far below chance, then given
function-preserving outlier channels. On it:

  1. online-predictor convergence: quantize W8A8 without calibration
     (empty outlier sets), run the sigma = 6 warmup on corpus batches, and
     read which planted channels every layer's q/k/v set found;
  2. the PPL matrix: per config and KV type, PPL on K disjoint held-out
     segments, mean and std, deltas paired with FP16 on the same segments,
     and the monotone-separation gate (fp16 <= mix8 <= mix4, the mix4 gap
     outside the paired noise band).

The mix8 rows are W8A8 as quantize_model gives it (empty, budget-reserved
outlier sets, no warmup), as in the JAX script, so they compare with its
records; `mix8_warmed` is the model the convergence check warmed, W8A8O16
with the outliers the predictor found (budget 32). QUIK rows wait for the
port of QUIK. Runs on the card unless --device cpu; trains every run.

  python examples/realistic_gate_torch.py --output gate.json
  python examples/realistic_gate_torch.py --device cpu --steps 40 --segments 2
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KVS = ("bfloat16", "int8")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=("tiny", "mid"))
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--train_batch", type=int, default=16)
    ap.add_argument("--seq_len", type=int, default=128)
    ap.add_argument("--corpus_tokens", type=int, default=200_000)
    ap.add_argument("--segments", type=int, default=4,
                    help="disjoint held-out eval segments (noise band)")
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--n_ctx", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--gain", type=float, default=8.0)
    ap.add_argument("--n_outliers", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None)
    return ap


def paired_row(row, ppls, base):
    """The deltas of `ppls` against FP16's on the same segments."""
    import numpy as np

    d = np.asarray(ppls) - np.asarray(base)
    row["delta_vs_fp16"] = round(float(d.mean()), 4)
    row["delta_std_paired"] = round(float(d.std()), 4)
    row["rel_delta_pct"] = round(
        100 * float(d.mean()) / float(np.mean(base)), 3)
    return row


def run(args, on_config=None):
    """The gate's rows. `on_config(name, params, specs, segments)`, when
    given, is called with each config's params (and the warmed W8A8O16
    params as "mix8_warmed") after its rows, before they are freed;
    `segments` are the held-out token streams."""
    import numpy as np
    import torch

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.eval import compute_perplexity
    from mixq_tpu_torch.models import DecoderSpecs, KVCache
    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.hf import params_from_source
    from mixq_tpu_torch.quantize import quantize_model
    from mixq_tpu_torch.quantize.online import warmup_online_outliers
    from mixq_tpu_torch.utils.substrate import (
        hf_state_from_params, plant_outlier_channels, substrate_cfg,
        synth_corpus, train_tiny_lm)
    from mixq_tpu_torch.utils.testing import DictSource

    dev = torch.device(args.device)
    cfg = substrate_cfg(args.preset)
    corpus = synth_corpus(cfg.vocab_size, args.corpus_tokens, seed=0)
    # held-out: the same language (phrase book seed 0), another stream
    held_out = synth_corpus(cfg.vocab_size, args.segments * args.windows
                            * args.n_ctx + 16, seed=0, sample_seed=1)

    t0 = time.perf_counter()
    params, loss = train_tiny_lm(
        cfg, corpus, steps=args.steps, batch=args.train_batch,
        seq_len=args.seq_len, log_every=100, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    train = {"check": "train_tiny_lm", "loss": loss,
             "chance": float(np.log(cfg.vocab_size)),
             "seconds": time.perf_counter() - t0, "steps": args.steps,
             "device": str(dev)}
    print(json.dumps(train), flush=True)
    state = hf_state_from_params(params, cfg)
    del params

    rng = np.random.RandomState(3)
    planted = np.sort(rng.choice(cfg.hidden_size, args.n_outliers,
                                 replace=False))
    inner = np.sort(rng.choice(cfg.intermediate_size, args.n_outliers,
                               replace=False))
    probe = torch.from_numpy(corpus[:64][None].astype(np.int64)).to(dev)
    fp_specs = DecoderSpecs.fp16()

    @torch.inference_mode()
    def fp_logits(st):
        p = params_from_source(DictSource(st), cfg, fp_specs, device=dev)
        cache = KVCache.create(cfg.num_hidden_layers, 1, 64,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               torch.bfloat16, device=dev)
        return forward(p, probe, cache, fp_specs, cfg,
                       head_f32=lm_head_f32(p, fp_specs))[0].cpu().numpy()

    base_logits = fp_logits(state)
    state = plant_outlier_channels(
        {k: v.copy() for k, v in state.items()}, cfg, planted,
        gain=args.gain, inner_channels=inner)
    planted_logits = fp_logits(state)
    drift = float(np.max(np.abs(planted_logits - base_logits))
                  / (np.max(np.abs(base_logits)) + 1e-9))
    print(json.dumps({"check": "plant_function_preserving",
                      "max_rel_logit_drift": round(drift, 6)}), flush=True)
    src = DictSource(state)
    rows = [train, {"check": "plant_function_preserving", "drift": drift,
                    "planted": planted.tolist(), "inner": inner.tolist()}]

    # ---- online-predictor convergence on the planted substrate ----
    qcfg = QuantConfig.w8a8(outlier_budget=32)
    warmed, warmed_specs = quantize_model(src, cfg, qcfg, device=dev)
    warm = [corpus[i * 4096:(i * 4096) + 4 * 64].reshape(4, 64)
            for i in range(2)]
    warmed, counts = warmup_online_outliers(
        warmed, cfg, warmed_specs, warm, sigma=qcfg.outlier_sigma,
        max_steps=qcfg.warmup_steps)
    hits, misses = {}, {}
    for i, bp in enumerate(warmed.blocks):
        found = set(bp.attn.wq.out_ind[bp.attn.wq.out_mask > 0].tolist())
        hits[i] = sum(1 for c in planted if int(c) in found)
        if hits[i] < len(planted):
            misses[i] = sorted(set(map(int, planted)) - found)
    row = {"check": "online_predictor_convergence",
           "planted": len(planted), "per_layer_hits": hits,
           "misses": misses, "counts_sample": dict(list(counts.items())[:6])}
    rows.append(row)
    print(json.dumps(row), flush=True)

    # ---- the PPL matrix ----
    calib = [corpus[-(i + 1) * 2048:][:512].reshape(4, 128)
             for i in range(2)]
    configs = {
        "fp16": None,
        "mix8": QuantConfig.w8a8(),
        "mix4": QuantConfig.w4a4(),
        "mix4_g64": QuantConfig.w4a4(q_group_size=64),
        "mix4_full_g64": QuantConfig.w4a4(q_group_size=64,
                                          eightbit_only_names=()),
        "mix8_warmed": "warmed",
    }
    print("# quik: not run; QUIK linears wait for their port "
          "(ROADMAP.md Queue A item 4)", flush=True)
    seg_len = args.windows * args.n_ctx
    segments = [held_out[s * seg_len:(s + 1) * seg_len + 1]
                for s in range(args.segments)]
    seg_ppls = {}              # (config, kv) -> [ppl per segment]
    for name, q in configs.items():
        t0 = time.perf_counter()
        if q is None:
            specs = fp_specs
            params = params_from_source(src, cfg, specs, device=dev)
        elif q == "warmed":
            params, specs = warmed, warmed_specs
            warmed = None
        else:
            params, specs = quantize_model(src, cfg, q, calib_batches=calib,
                                           device=dev)
        for kv in KVS:
            ppls = [compute_perplexity(
                params, cfg, seg, specs, n_ctx=args.n_ctx,
                batch_size=args.batch, kv_dtype=kv,
                max_windows=args.windows).ppl for seg in segments]
            seg_ppls[(name, kv)] = ppls
            row = {"config": name, "kv": kv,
                   "ppl_mean": round(float(np.mean(ppls)), 4),
                   "ppl_std": round(float(np.std(ppls)), 4),
                   "segments": args.segments, "windows": args.windows,
                   "preset": args.preset, "device": str(dev),
                   "seconds": round(time.perf_counter() - t0, 1)}
            base = seg_ppls.get(("fp16", "bfloat16"))
            if base:
                paired_row(row, ppls, base)
            rows.append(row)
            print(json.dumps(row), flush=True)
        if on_config is not None:
            on_config(name, params, specs, segments)
        del params

    def paired(name):
        d = (np.asarray(seg_ppls[(name, "bfloat16")])
             - np.asarray(seg_ppls[("fp16", "bfloat16")]))
        # the claim is about the mean paired delta over n segments: the band
        # is 2 standard errors
        return float(d.mean()), float(d.std() / np.sqrt(len(d)))

    d8, s8 = paired("mix8")
    d4, s4 = paired("mix4")
    band = 2.0 * max(s8, s4, 1e-9)
    fp = float(np.mean(seg_ppls[("fp16", "bfloat16")]))
    gate = {"check": "monotone_separation",
            "fp16_ppl": round(fp, 4),
            "mix8_delta": round(d8, 4), "mix4_delta": round(d4, 4),
            "paired_band_2se": round(band, 4),
            "monotone": bool(d8 <= d4 + band and -band <= d8),
            "mix4_gap_significant": bool(d4 > band)}
    rows.append(gate)
    print(json.dumps(gate), flush=True)
    return rows


def main():
    args = parser().parse_args()
    rows = run(args)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print(f"# wrote {args.output}", flush=True)


if __name__ == "__main__":
    main()
