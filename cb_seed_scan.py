#!/usr/bin/env python3
"""The seed scan behind the continuous-batching card-vs-CPU checks (one
CUDA card): chip_smoke.py's phase 4 CB check and the card test
tests/test_torch_gpu.py::test_cb_tokens_on_the_card_equal_the_cpu.

    python3 cb_seed_scan.py [--seeds 16]

For each seed of the requests' prompts and each layout, the tiny W8A8
llama served by the CB engine on the card and on the CPU, each request
then replayed teacher-forced on both, as the two checks read it but
without their limit: the largest logits gap over max|logits|, the tokens
held equal (those before a request's first near-tie: a step whose top-2
margin is not above twice its gap) and the requests whose card tokens
leave the CPU's before one. Prints one JSON line per seed and check and
writes them all to chiprun_out/cb_seed_scan.json.
"""
import argparse
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cb_seed_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import chip_smoke as S
    import test_torch_gpu as T

    dev = torch.device("cuda")
    S.CB_TINY_TOL = float("inf")          # read the gaps, hold no limit
    cfg, specs, cpu, card = T._cb_world(dev)
    lines = []
    for seed in range(args.seeds):
        res = S.cb_reference(dev, seed)
        lines.append({"check": "phase 4", "seed": seed, **{
            k: dict(max_logits_gap=v["max_logits_gap"],
                    tokens_held_equal=v["tokens_held_equal"],
                    tokens=v["tokens"], near_ties=len(v["near_ties"]))
            for k, v in res.items()}})
        for attn, kv in T.CB_LAYOUTS:
            _, held = T.cb_card_vs_cpu(cfg, specs, cpu, card, dev, attn, kv,
                                       seed)
            lines.append(dict(
                check="card test", seed=seed, layout=f"{attn} {kv}",
                max_logits_gap=max(g for g, _, _ in held),
                tokens_held_equal=sum(n for _, n, _ in held),
                leave_before_a_near_tie=sum(not e for _, _, e in held)))
        for line in lines[-1 - len(T.CB_LAYOUTS):]:
            print(json.dumps(line), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "cb_seed_scan.json"),
              "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
