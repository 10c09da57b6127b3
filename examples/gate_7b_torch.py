"""The 7B-shape accuracy gate on the PyTorch port (mirrors
examples/gate_7b.py).

The trained-substrate gate (examples/realistic_gate_torch.py) runs a
4-layer model; quantization error accumulates over depth. This script puts
the same paired-delta PPL matrix on Llama-2-7B's full shape and depth,
on the Markov-readout substrate (mixq_tpu_torch/utils/substrate.py::
make_markov_state):

  * the planted successor chain gives every token a known argmax with a
    tunable logit margin; --margin sets the operating point, so FP16's NLL
    is small but finite and damage moves it (margin 30, the serving
    default, sits at PPL 1.0, numb to damage);
  * --block_scale sets how much the 32 random blocks add to the residual
    stream: their int8/int4 weight quantization noise is the
    accumulated-over-depth damage the gate must see;
  * outlier channels are planted once, on the shared block (every layer
    aliases it; planting per layer would compound the gain 32 times).

Rows: {fp16, mix8, mix4} x {bfloat16, int8 KV}, PPL per held-out chain
segment, deltas paired with FP16 on the same segments, and the
monotone-separation gate. QUIK rows wait for the port of QUIK. The
state's arrays go to the card once (substrate.device_state: one block's
worth, shared by every layer) and each config is quantized from there.
Runs on the card unless --device cpu.

  python examples/gate_7b_torch.py --output gate_7b.json
  python examples/gate_7b_torch.py --device cpu --layers 3 --hidden 256
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=0,
                    help="0 = Llama-2-7B's shape; smaller for a CPU smoke")
    ap.add_argument("--margin", type=float, default=7.0)
    ap.add_argument("--block_scale", type=float, default=2e-3)
    ap.add_argument("--v_eff", type=int, default=512)
    ap.add_argument("--n_outliers", type=int, default=6)
    ap.add_argument("--gain", type=float, default=8.0)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--windows", type=int, default=8)
    ap.add_argument("--n_ctx", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--configs", default="fp16,mix8,mix4")
    ap.add_argument("--kv", default="bfloat16,int8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None)
    return ap


def model_cfg(args):
    """Llama-2-7B (presets.llama2_7b, bench.py's) at --layers, or a
    narrow llama of the same proportions at --hidden."""
    from mixq_tpu_torch.config import ModelConfig
    from mixq_tpu_torch.presets import llama2_7b

    if args.hidden:
        return ModelConfig(
            model_type="llama", vocab_size=2048, hidden_size=args.hidden,
            intermediate_size=args.hidden * 11008 // 4096,
            num_hidden_layers=args.layers,
            num_attention_heads=max(args.hidden // 128, 2),
            num_key_value_heads=max(args.hidden // 128, 2),
            max_position_embeddings=2048)
    return dataclasses.replace(llama2_7b(), num_hidden_layers=args.layers)


def substrate(args):
    """The planted Markov state and its held-out text, as a namespace:
    cfg, src (a TensorSource over the planted state on the device),
    walk(start, n) (a chain walk), calib, segments and the planting
    row."""
    import numpy as np
    import torch

    from mixq_tpu_torch.models import DecoderSpecs, KVCache
    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.hf import params_from_source
    from mixq_tpu_torch.utils.substrate import (device_state,
                                                make_markov_state,
                                                plant_outlier_channels)
    from mixq_tpu_torch.utils.testing import DictSource

    dev = torch.device(args.device)
    cfg = model_cfg(args)
    v_eff = min(args.v_eff, cfg.vocab_size, cfg.hidden_size)
    t0 = time.perf_counter()
    state, succ = make_markov_state(
        cfg, v_eff=v_eff, seed=0, margin=args.margin,
        block_scale=args.block_scale, mean_cycle=48, share_blocks=True)
    print(f"# substrate built in {time.perf_counter() - t0:.1f} s "
          f"(margin {args.margin}, block_scale {args.block_scale})",
          flush=True)

    rng = np.random.RandomState(3)
    planted = np.sort(rng.choice(cfg.hidden_size, args.n_outliers,
                                 replace=False))
    inner = np.sort(rng.choice(cfg.intermediate_size, args.n_outliers,
                               replace=False))
    fp_specs = DecoderSpecs.fp16()

    def walk(start, n):
        out = [int(start)]
        for _ in range(n - 1):
            out.append(int(succ[out[-1]]))
        return out

    probe = torch.tensor([walk(2, 64)], dtype=torch.int64, device=dev)

    @torch.inference_mode()
    def fp_logits(st):
        p = params_from_source(DictSource(device_state(st, dev)), cfg,
                               fp_specs, device=dev)
        cache = KVCache.create(cfg.num_hidden_layers, 1, 64,
                               cfg.num_key_value_heads, cfg.head_dim_,
                               torch.bfloat16, device=dev)
        out = forward(p, probe, cache, fp_specs, cfg,
                      head_f32=lm_head_f32(p, fp_specs))[0]
        return out[:, :, :v_eff].cpu().numpy()

    base_logits = fp_logits(state)
    # once, on the shared block: a one-layer cfg plants layer 0, whose
    # arrays every layer aliases
    cfg1 = dataclasses.replace(cfg, num_hidden_layers=1)
    state = plant_outlier_channels(state, cfg1, planted, gain=args.gain,
                                   inner_channels=inner)
    planted_logits = fp_logits(state)
    drift = float(np.max(np.abs(planted_logits - base_logits))
                  / (np.max(np.abs(base_logits)) + 1e-9))
    row = {"check": "plant_function_preserving",
           "max_rel_logit_drift": round(drift, 6),
           "planted": planted.tolist(), "layers": cfg.num_hidden_layers,
           "margin": args.margin, "block_scale": args.block_scale}
    print(json.dumps(row), flush=True)

    seg_len = args.windows * args.n_ctx
    return types.SimpleNamespace(
        cfg=cfg, src=DictSource(device_state(state, dev)), walk=walk,
        row=row,
        # calibration and held-out text: chain walks from disjoint starts
        calib=[np.asarray(walk(3 + i, 512), np.int32).reshape(4, 128)
               for i in range(2)],
        segments=[np.asarray(walk(11 + 7 * s, seg_len + 1), np.int32)
                  for s in range(args.segments)])


def run(args, on_config=None):
    """The gate's rows. `on_config(name, params, specs, gate)`, when given,
    is called with each config's params after its rows, before they are
    freed; `gate` is substrate()'s namespace."""
    import numpy as np
    import torch

    from mixq_tpu_torch.config import QuantConfig
    from mixq_tpu_torch.eval import compute_perplexity
    from mixq_tpu_torch.models import DecoderSpecs
    from mixq_tpu_torch.models.hf import params_from_source
    from mixq_tpu_torch.quantize import quantize_model

    dev = torch.device(args.device)
    gate = substrate(args)
    cfg = gate.cfg
    rows = [gate.row]
    qconfigs = {"fp16": None, "mix8": QuantConfig.w8a8(),
                "mix4": QuantConfig.w4a4()}
    want = args.configs.split(",")
    if "quik" in want:
        print("# quik: not run; QUIK linears wait for their port "
              "(ROADMAP.md Queue A item 4)", flush=True)
        want.remove("quik")
    kvs = args.kv.split(",")
    seg_ppls = {}
    for name in want:
        q = qconfigs[name]
        t0 = time.perf_counter()
        if q is None:
            specs = DecoderSpecs.fp16()
            params = params_from_source(gate.src, cfg, specs, device=dev)
        else:
            params, specs = quantize_model(gate.src, cfg, q,
                                           calib_batches=gate.calib,
                                           device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        print(f"# {name}: params ready {time.perf_counter() - t0:.1f} s",
              flush=True)
        for kv in kvs:
            t1 = time.perf_counter()
            ppls = [compute_perplexity(
                params, cfg, seg, specs, n_ctx=args.n_ctx,
                batch_size=args.batch, kv_dtype=kv,
                max_windows=args.windows).ppl for seg in gate.segments]
            seconds = time.perf_counter() - t1
            seg_ppls[(name, kv)] = ppls
            row = {"config": name, "kv": kv,
                   "ppl_mean": round(float(np.mean(ppls)), 5),
                   "ppl_std": round(float(np.std(ppls)), 5),
                   "segments": args.segments, "preset": "7b",
                   "layers": cfg.num_hidden_layers, "device": str(dev),
                   "seconds": round(seconds, 2),
                   # evaluated tokens (windows x n_ctx) over the wall
                   "tokens_per_s": round(len(gate.segments) * args.windows
                                         * args.n_ctx / seconds, 1)}
            base = seg_ppls.get(("fp16", kvs[0]))
            if base:
                d = np.asarray(ppls) - np.asarray(base)
                row["delta_vs_fp16"] = round(float(d.mean()), 5)
                row["delta_se_paired"] = round(
                    float(d.std() / np.sqrt(len(d))), 5)
                row["rel_delta_pct"] = round(
                    100 * float(d.mean()) / float(np.mean(base)), 4)
            rows.append(row)
            print(json.dumps(row), flush=True)
        if on_config is not None:
            on_config(name, params, specs, gate)
        del params

    def paired(name):
        d = (np.asarray(seg_ppls[(name, kvs[0])])
             - np.asarray(seg_ppls[("fp16", kvs[0])]))
        return float(d.mean()), float(d.std() / np.sqrt(len(d)))

    if "fp16" in want and "mix8" in want and "mix4" in want:
        d8, s8 = paired("mix8")
        d4, s4 = paired("mix4")
        band = 2.0 * max(s8, s4, 1e-9)
        gate_row = {"check": "monotone_separation_7b",
                    "fp16_ppl": round(float(np.mean(
                        seg_ppls[("fp16", kvs[0])])), 5),
                    "mix8_delta": round(d8, 5), "mix4_delta": round(d4, 5),
                    "paired_band_2se": round(band, 5),
                    "monotone": bool(d8 <= d4 + band and -band <= d8),
                    "mix4_gap_significant": bool(d4 > band),
                    "layers": cfg.num_hidden_layers}
        rows.append(gate_row)
        print(json.dumps(gate_row), flush=True)
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
