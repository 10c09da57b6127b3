#!/usr/bin/env python3
"""The planting scan behind chip_smoke.py's phase 7 (one CUDA card).

    python3 phase7_scan.py [--boosts 200,250,300,400]

For each boost of the PLANTED embedding channels: Llama-2-7B at full
width and depth from chip_smoke.float_state_dict on the card, through
quantize_model W8A8 and InferenceEngine.warmup_online (phase 7's batches),
then, as phase 7 reads them but without its limits:
  - the planted channels' lowest normed maximum over every layer's wqkv
    and up slots, in sigmas, for each warmup step;
  - one prefill's logits (8 x 64 tokens) against the FP16-spec model of
    the same weights (chip_smoke.logits_gap): the warmed model, the same
    with its promoted rows zeroed, and the model before warmup;
  - generate of phase 7's 8 prompts x 32 tokens (chip_smoke.serve): how
    many rows differ and how many repeat one token.
Prints one JSON line per boost and writes them all to
chiprun_out/phase7_scan.json.
"""
import argparse
import gc
import json
import os
import sys
import time

import torch


def scan(dev, boost):
    import chip_smoke as S
    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.models.decoder import DecoderSpecs
    from mixq_tpu_torch.models.hf import TensorSource, params_from_source
    from mixq_tpu_torch.quantize import quantize_model

    cfg = S.llama2_7b()
    sd = S.float_state_dict(cfg, dev, boost=boost)
    src = TensorSource.from_torch_state_dict(sd)
    params, specs = quantize_model(src, cfg, QuantConfig.w8a8(), device=dev)
    fp_specs = DecoderSpecs.fp16()
    fp_params = params_from_source(src, cfg, fp_specs, device=dev)
    tokens = S.token_batches(cfg, 1, 8, 64, seed=24)[0].to(dev, torch.int32)
    ref = S.prefill_logits(fp_params, cfg, fp_specs, tokens)
    before = S.logits_gap(S.prefill_logits(params, cfg, specs, tokens), ref)
    del sd, src, fp_params
    gc.collect()
    torch.cuda.empty_cache()
    eng = S.new_engine(dev, params, cfg, specs, "int8")
    del params
    log = []
    counts = eng.warmup_online(S.token_batches(cfg, 2, 8, 64, seed=22),
                               stats_log=log)
    logits = dict(
        warmed=S.logits_gap(S.prefill_logits(eng.params, cfg, specs, tokens,
                                             eng.head_f32), ref),
        promoted_rows_dropped=S.logits_gap(S.prefill_logits(
            S.drop_promoted_rows(eng.params), cfg, specs, tokens,
            eng.head_f32), ref),
        before_warmup=before)
    _, served = S.serve(dev, None, cfg, specs, "W8A8", "int8", eng=eng)
    return dict(boost=boost, embed_std=S.EMBED_STD,
                planted_margin_by_step=S.planted_margins(
                    log, cfg.num_hidden_layers),
                logits_vs_fp16_spec=logits,
                distinct_rows=served["distinct_rows"],
                constant_rows=served["constant_rows"],
                counts_by_slot={s: [min(v), max(v)] for s, v in (
                    (s, [counts[f"{i}.{s}"]
                         for i in range(cfg.num_hidden_layers)])
                    for s in ("wqkv", "wo", "up", "down"))})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--boosts", default="200,250,300,400")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase7_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mixq_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    rows = []
    for boost in (float(b) for b in args.boosts.split(",")):
        t0 = time.perf_counter()
        row = scan(dev, boost)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "phase7_scan.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
