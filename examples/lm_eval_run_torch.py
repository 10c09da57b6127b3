"""EleutherAI lm-evaluation-harness runner on the PyTorch port (mirrors
examples/lm_eval_run.py): a quantized checkpoint wrapped in
eval.lm_eval_adaptor.MixQLM.

  python examples/lm_eval_run_torch.py --model_path <dir> \
      --tasks lambada_openai [--batch_size 8] [--max_length 2048] \
      [--limit 100] [--output out.json] [--device cpu]
  python examples/lm_eval_run_torch.py --offline_task all \
      [--model_path <dir>] [--device cpu]

The harness mode needs lm-eval and transformers' tokenizer, and exits as
JAX's runner does when lm_eval is missing. The offline mode drives the
vendored tasks (eval/offline_tasks.py) through the same adaptor interface
and needs neither: on a checkpoint (synthetic corpus of its vocabulary)
or, without --model_path, on the in-tree Markov substrate. Runs on the
card unless --device cpu.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--tokenizer_path", default=None)
    ap.add_argument("--tasks", default=None,
                    help="comma-separated lm-eval task names")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_length", type=int, default=2048)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--output", default=None, help="write results JSON here")
    ap.add_argument("--offline_task", default=None,
                    choices=("synth_cloze", "synth_completion", "all"),
                    help="vendored offline task driven through the "
                         "adaptor's harness interface; needs no lm-eval. "
                         "Uses --model_path if given, else the in-tree "
                         "Markov substrate.")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.offline_task:
        return run_offline(args)
    if not args.model_path or not args.tasks:
        sys.exit("--model_path and --tasks are required (or use "
                 "--offline_task)")

    try:
        import lm_eval
    except ImportError:
        sys.exit("lm_eval is not installed; pip install lm-eval to run the "
                 "harness (the MixQLM adaptor itself has no harness "
                 "dependency and is tested standalone)")

    from mixq_tpu_torch.eval.lm_eval_adaptor import MixQLM
    from mixq_tpu_torch.models.auto import AutoModel
    from mixq_tpu_torch.utils.calib_data import load_tokenizer

    tok = load_tokenizer(args.tokenizer_path or args.model_path)
    params, cfg, specs = AutoModel.from_quantized(args.model_path,
                                                  device=args.device)
    lm = MixQLM(params, cfg, specs, tok,
                batch_size=args.batch_size, max_length=args.max_length)

    results = lm_eval.simple_evaluate(
        model=lm, tasks=args.tasks.split(","), limit=args.limit)
    print(json.dumps(results.get("results", results), indent=2, default=str))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2, default=str)


def run_offline(args):
    """The vendored tasks through the MixQLM request/response interface
    the external harness drives."""
    import numpy as np

    from mixq_tpu_torch.eval.lm_eval_adaptor import MixQLM
    from mixq_tpu_torch.eval.offline_tasks import (IntTokenizer,
                                                   build_cloze_task,
                                                   build_completion_task,
                                                   evaluate_cloze,
                                                   evaluate_completion)
    from mixq_tpu_torch.utils.substrate import synth_corpus

    if args.model_path:
        from mixq_tpu_torch.models.auto import AutoModel

        params, cfg, specs = AutoModel.from_quantized(args.model_path,
                                                      device=args.device)
        corpus = synth_corpus(cfg.vocab_size, 8192, seed=0, sample_seed=2)
    else:
        from mixq_tpu_torch.config import ModelConfig
        from mixq_tpu_torch.models import DecoderSpecs
        from mixq_tpu_torch.models.hf import params_from_source
        from mixq_tpu_torch.utils.substrate import make_markov_state
        from mixq_tpu_torch.utils.testing import DictSource

        cfg = ModelConfig(model_type="llama", vocab_size=512,
                          hidden_size=256, intermediate_size=704,
                          num_hidden_layers=2, num_attention_heads=4,
                          num_key_value_heads=4)
        state, succ = make_markov_state(cfg, v_eff=128, seed=0,
                                        mean_cycle=12)
        specs = DecoderSpecs.fp16()
        params = params_from_source(DictSource(state), cfg, specs,
                                    device=args.device)
        walk = [5]
        for _ in range(2000):
            walk.append(int(succ[walk[-1]]))
        corpus = np.asarray(walk, np.int32)

    lm = MixQLM(params, cfg, specs, IntTokenizer(),
                batch_size=args.batch_size,
                max_length=min(args.max_length, 128))
    results = []
    n = args.limit or 32
    if args.offline_task in ("synth_cloze", "all"):
        results.append(evaluate_cloze(
            lm, build_cloze_task(corpus, n_items=n, ctx_len=12, cont_len=3)))
    if args.offline_task in ("synth_completion", "all"):
        results.append(evaluate_completion(
            lm, build_completion_task(corpus, n_items=max(n // 2, 4),
                                      ctx_len=12, gen_len=3)))
    for r in results:
        print(json.dumps(r))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
