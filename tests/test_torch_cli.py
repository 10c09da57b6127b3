"""PyTorch port: the CLIs that load checkpoints (basic_quant_mix_torch,
basic_quant_quik_torch, get_act_scales_torch, generate_torch,
evalppl_torch, benchflops_torch, serve_cb_torch, lm_eval_run_torch), on
the CPU with --device cpu, over a tiny HF llama written by transformers
(tests/test_torch_auto.py's).

Six run as scripts in subprocesses where importing jax, mixq_tpu,
safetensors or transformers raises; the rest call the scripts'
main(argv) in this process.
- basic_quant_mix_torch.py's W8A8O16 checkpoint and
  basic_quant_quik_torch.py's QUIK W4A4 checkpoint (calibrated on a token
  file) load in JAX's load_checkpoint bit-equal to the port's in-process
  AutoModel.from_pretrained of the same directory.
- evalppl_torch.py's PPL equals the in-process compute_perplexity's, on a
  checkpoint and with --model_type quik on the HF directory.
- generate_torch.py --prompt_ids and serve_cb_torch.py give the
  in-process engine's greedy tokens; benchflops_torch.py writes a row per
  batch size naming the device.
- get_act_scales_torch.py's scales equal the in-process
  collect_act_scales'; lm_eval_run_torch.py's offline mode scores the
  checkpoint and the Markov substrate (>= 0.9 on the substrate, as JAX's).
- The calibration-leak guard and the harness mode without lm_eval exit
  with their message.
- Every module of the package and chip_smoke.py import with those four
  packages refused; the entry points and the CLIs default to the card."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mixq_tpu.quantize import load_checkpoint as j_load_checkpoint
from mixq_tpu_torch.config import EngineConfig, QuantConfig
from mixq_tpu_torch.eval import compute_perplexity
from mixq_tpu_torch.models.auto import AutoModel
from mixq_tpu_torch.quantize import collect_act_scales, load_act_scales
from mixq_tpu_torch.utils.calib_data import get_calib_dataset

import test_torch_auto as auto
import test_torch_checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = [[5, 17, 33, 2, 9], [101, 7], [64, 3, 3, 200, 11]]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


hf_dirs = auto.hf_dirs


# runs a script with those packages' imports refused
BLOCKED = """
import runpy, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "mixq_tpu", "safetensors",
                                  "transformers"):
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def run(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", BLOCKED,
                        os.path.join(REPO, script), *args, "--device", "cpu"],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=600)
    assert r.returncode == 0, f"{script}:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def script(path):
    """A CLI's module, loaded from its file (its main(argv))."""
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ckpt(hf_dirs, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli") / "w8a8")
    run("examples/basic_quant_mix_torch.py", "--model_path",
        hf_dirs["bf16"], "--quant_file", d, "--w_bit", "8",
        "--outlier_budget", "16")
    return d


def test_quantized_checkpoint_loads_in_jax(hf_dirs, ckpt):
    jp, jcfg, jq = j_load_checkpoint(ckpt)
    assert (jq.w_bit, jq.a_bit, jq.version, jq.outlier_budget) == (
        8, 8, "MIX", 16)
    tp, tcfg, _ = AutoModel.from_pretrained(
        hf_dirs["bf16"], QuantConfig.w8a8(outlier_budget=16), device="cpu")
    assert tcfg == ck.cfg_port(jcfg)
    ck.assert_bit_equal_to_jax(tp, jp)


def test_evalppl_equals_in_process(ckpt, tmp_path):
    tokens = np.random.RandomState(0).randint(0, 256, 1024).astype(np.int32)
    path = str(tmp_path / "tokens.npy")
    np.save(path, tokens)
    csv_path = str(tmp_path / "ppl.csv")
    row = json.loads(run("evalppl_torch.py", "--model_path", ckpt,
                         "--eval_tokens", path, "--n_ctx", "64", "--batch",
                         "4", "--max_windows", "6", "--output_csv",
                         csv_path).strip().splitlines()[-1])
    params, cfg, specs = AutoModel.from_quantized(ckpt, device="cpu")
    ref = compute_perplexity(params, cfg, tokens, specs, n_ctx=64,
                             batch_size=4, max_windows=6)
    assert row["ppl"] == ref.ppl and row["windows"] == 6
    assert row["device"] == "cpu" and os.path.exists(csv_path)


def calib_tokens(tmp_path):
    path = str(tmp_path / "calib.npy")
    np.save(path, np.random.RandomState(1).randint(0, 256, 4096).astype(
        np.int32))
    return path


def test_quik_checkpoint_loads_in_jax(hf_dirs, tmp_path):
    calib = calib_tokens(tmp_path)
    d = str(tmp_path / "quik")
    run("examples/basic_quant_quik_torch.py", "--model_path",
        hf_dirs["bf16"], "--quant_file", d, "--outlier_budget", "16",
        "--calib_tokens", calib, "--calib_samples", "2")
    jp, jcfg, jq = j_load_checkpoint(d)
    assert (jq.w_bit, jq.a_bit, jq.version, jq.outlier_budget) == (
        4, 4, "QUIK", 16)
    tp, tcfg, specs = AutoModel.from_pretrained(
        hf_dirs["bf16"], QuantConfig.quik_w4a4(outlier_budget=16),
        calib_batches=get_calib_dataset(tokens_path=calib, n_samples=2,
                                        vocab_size=256), device="cpu")
    assert tcfg == ck.cfg_port(jcfg) and specs.wqkv.version == "QUIK"
    assert tp.blocks[0].attn.wq.reduced_w is not None
    ck.assert_bit_equal_to_jax(tp, jp)


def test_evalppl_quik_equals_in_process(hf_dirs, tmp_path, capsys):
    from mixq_tpu_torch.utils.calib_data import blocks_from_tokens

    tokens = np.random.RandomState(0).randint(0, 256, 1024).astype(np.int32)
    path = str(tmp_path / "tokens.npy")
    np.save(path, tokens)
    calib = calib_tokens(tmp_path)
    script("evalppl_torch.py").main([
        "--model_path", hf_dirs["f32"], "--model_type", "quik",
        "--eval_tokens", path, "--calib_tokens", calib, "--n_ctx", "64",
        "--batch", "4", "--max_windows", "4", "--device", "cpu"])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    params, cfg, specs = AutoModel.from_pretrained(
        hf_dirs["f32"], QuantConfig.quik_w4a4(),
        calib_batches=blocks_from_tokens(np.load(calib), n_samples=16,
                                         block_len=64), device="cpu")
    ref = compute_perplexity(params, cfg, tokens, specs, n_ctx=64,
                             batch_size=4, max_windows=4)
    assert row["backend"] == "quik" and row["ppl"] == ref.ppl
    assert np.isfinite(row["ppl"]) and row["windows"] == 4


def test_generate_and_serve_give_in_process_tokens(ckpt, tmp_path):
    eng = AutoModel.engine(ckpt, EngineConfig(max_seq_len=2048),
                           device="cpu")
    ref = eng.generate(PROMPTS, max_new_tokens=6)
    out = run("generate_torch.py", "--model_path", ckpt, "--prompt_ids",
              *[",".join(map(str, p)) for p in PROMPTS],
              "--max_new_tokens", "6")
    rows = [json.loads(x) for x in out.strip().splitlines()]
    assert [r["prompt_ids"] for r in rows] == PROMPTS
    assert [r["token_ids"] for r in rows] == ref

    reqs = str(tmp_path / "reqs.jsonl")
    with open(reqs, "w") as f:
        for p in PROMPTS:
            f.write(json.dumps({"prompt_ids": p, "max_new_tokens": 6}) + "\n")
        f.write(json.dumps({"prompt": "text, no tokenizer"}) + "\n")
    out = run("examples/serve_cb_torch.py", "--model_path", ckpt,
              "--requests", reqs, "--slots", "2", "--max_seq", "64")
    recs = [json.loads(x) for x in out.strip().splitlines()]
    assert any("no tokenizer" in r.get("error", "") for r in recs)
    got = {r["id"]: r["token_ids"] for r in recs if "id" in r}
    single = AutoModel.engine(ckpt, EngineConfig(max_seq_len=64,
                                                 prefill_chunk=8),
                              device="cpu")
    assert [got[i] for i in range(len(PROMPTS))] == [
        single.generate([p], 6)[0] for p in PROMPTS]


def test_benchflops_rows(ckpt):
    out = run("benchflops_torch.py", "--model_path", ckpt, "--batch_sizes",
              "1,2", "--n_generate", "2", "--prompt_len", "8")
    rows = [json.loads(x) for x in out.strip().splitlines()]
    assert [r["batch"] for r in rows] == [1, 2]
    assert all(r["device"] == "cpu" and r["tokens_per_s"] > 0 for r in rows)


def test_act_scales_equal_in_process(hf_dirs, tmp_path):
    out = str(tmp_path / "scales.npz")
    script("examples/get_act_scales_torch.py").main([
        "--model_path", hf_dirs["f32"], "--output", out, "--calib_samples",
        "2", "--device", "cpu"])
    params, cfg, specs = AutoModel.from_pretrained(hf_dirs["f32"],
                                                   device="cpu")
    ref = collect_act_scales(params, cfg, get_calib_dataset(
        n_samples=2, vocab_size=cfg.vocab_size), specs)
    got = load_act_scales(out)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.array_equal(got[k], v.numpy()), k


def test_lm_eval_offline(ckpt):
    mod = script("examples/lm_eval_run_torch.py")
    on_ckpt = mod.main(["--offline_task", "all", "--model_path", ckpt,
                        "--limit", "8", "--device", "cpu"])
    assert [r["n"] for r in on_ckpt] == [8, 4]
    assert all(0 <= r[r["metric"]] <= 1 for r in on_ckpt)
    markov = mod.main(["--offline_task", "all", "--limit", "8",
                       "--device", "cpu"])
    assert all(r[r["metric"]] >= 0.9 for r in markov), markov


@pytest.mark.parametrize("path,argv,message", [
    ("evalppl_torch.py", ["--model_type", "mix4"], "leaks eval data"),
    ("evalppl_torch.py", ["--model_type", "quik"], "leaks eval data"),
    ("examples/lm_eval_run_torch.py", ["--tasks", "lambada"],
     "lm_eval is not installed"),
])
def test_refusals_exit_with_their_message(hf_dirs, tmp_path, path, argv,
                                          message):
    tokens = str(tmp_path / "tokens.npy")
    np.save(tokens, np.arange(512, dtype=np.int32) % 256)
    extra = (["--eval_tokens", tokens] if path == "evalppl_torch.py"
             else [])
    with pytest.raises(SystemExit, match=message):
        script(path).main(["--model_path", hf_dirs["f32"], *argv, *extra,
                           "--device", "cpu"])


def test_no_module_imports_jax_safetensors_or_transformers():
    """Every module of the package and chip_smoke.py import with jax,
    mixq_tpu, safetensors and transformers refused."""
    code = BLOCKED.split("sys.argv = ")[0] + (
        "import importlib, pkgutil\n"
        "import mixq_tpu_torch\n"
        "for m in pkgutil.walk_packages(mixq_tpu_torch.__path__,"
        " 'mixq_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_entry_points_default_to_the_card():
    import inspect

    from mixq_tpu_torch.models.hf import load_model
    from mixq_tpu_torch.quantize import load_checkpoint

    for fn in (AutoModel.from_pretrained, AutoModel.from_quantized,
               AutoModel.engine, AutoModel.serving_engine, load_model,
               load_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for path in ("generate_torch.py", "evalppl_torch.py",
                 "benchflops_torch.py", "examples/basic_quant_mix_torch.py",
                 "examples/basic_quant_quik_torch.py",
                 "examples/get_act_scales_torch.py",
                 "examples/serve_cb_torch.py",
                 "examples/lm_eval_run_torch.py"):
        assert script(path).parser().get_default("device") == "cuda", path
