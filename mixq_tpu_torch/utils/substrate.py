"""Evaluation substrates (mirrors mixq_tpu/utils/substrate.py).

Random-weight models have chance-level perplexity, so the quantization
damage the accuracy gate exists to catch ("W8A8O16 within 0.1 of FP16",
BASELINE.md) vanishes into noise. These builders make deterministic
substrates on which it shows:

  synth_corpus           a learnable synthetic language (a Zipf phrase book
                         over a Zipf vocabulary) as a token stream
  train_tiny_lm          trains the port's decoder (models/decoder.forward)
                         on the corpus with torch.optim.Adam, on the card
                         unless the caller asks for the CPU
  hf_state_from_params   DecoderParams (FP16 specs) -> HF-llama numpy dict,
                         the inverse of models/hf.py::params_from_source
  plant_outlier_channels function-preserving outlier channels in a trained
                         model: norm gains and producer columns times g,
                         consumer rows divided by g
  make_markov_state      a cfg-shaped (e.g. 7B) model whose greedy output
                         follows a planted Markov chain
  device_state           an HF dict's arrays as tensors on a device, one
                         tensor per distinct array (aliasing kept)

The numpy builders are copies of JAX's and draw the same numbers from the
same seeds, so their outputs are bit-equal to JAX's.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mixq_tpu_torch.config import ModelConfig

__all__ = [
    "synth_corpus", "train_tiny_lm", "lm_loss", "hf_state_from_params",
    "plant_outlier_channels", "make_markov_state", "substrate_cfg",
    "device_state",
]


def substrate_cfg(preset: str = "tiny") -> ModelConfig:
    """Model shapes for the trained substrates (small enough to train in
    seconds, deep enough that per-layer quantization error compounds)."""
    shapes = {
        "tiny": dict(hidden_size=256, intermediate_size=704,
                     num_hidden_layers=4, num_attention_heads=4,
                     num_key_value_heads=4, vocab_size=2048,
                     max_position_embeddings=512),
        "mid": dict(hidden_size=512, intermediate_size=1408,
                    num_hidden_layers=6, num_attention_heads=8,
                    num_key_value_heads=8, vocab_size=4096,
                    max_position_embeddings=512),
    }
    return ModelConfig(model_type="llama", tie_word_embeddings=False,
                       **shapes[preset])


# ---------------------------------------------------------------------------
# Corpus
# ---------------------------------------------------------------------------

def synth_corpus(
    vocab_size: int,
    n_tokens: int,
    seed: int = 0,
    n_phrases: int = 384,
    phrase_len: Tuple[int, int] = (3, 9),
    noise: float = 0.03,
    sample_seed: Optional[int] = None,
) -> np.ndarray:
    """A phrase book of `n_phrases` token sequences (tokens Zipf-weighted
    over [2, vocab)), emitted with Zipf phrase weights plus a `noise`
    share of single random tokens. Tokens 0 (pad) and 1 (BOS) never
    occur. `seed` fixes the language (the phrase book), `sample_seed`
    (default: seed) only the emission stream: held-out text is the same
    language with another sample_seed."""
    rng_book = np.random.RandomState(seed)
    rng = np.random.RandomState(seed if sample_seed is None else sample_seed)
    toks = np.arange(2, vocab_size)
    tok_p = 1.0 / (np.arange(len(toks)) + 2.0) ** 1.1
    tok_p /= tok_p.sum()
    phrases = [
        rng_book.choice(toks, size=rng_book.randint(*phrase_len), p=tok_p)
        for _ in range(n_phrases)
    ]
    phrase_p = 1.0 / (np.arange(n_phrases) + 2.0) ** 1.05
    phrase_p /= phrase_p.sum()

    out = np.empty(n_tokens + 16, np.int32)
    i = 0
    while i < n_tokens:
        if rng.rand() < noise:
            out[i] = rng.choice(toks, p=tok_p)
            i += 1
            continue
        ph = phrases[rng.choice(n_phrases, p=phrase_p)]
        n = min(len(ph), len(out) - i)
        out[i:i + n] = ph[:n]
        i += n
    return out[:n_tokens]


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def lm_loss(params, tokens: torch.Tensor, cfg: ModelConfig,
            specs) -> torch.Tensor:
    """Mean next-token NLL of tokens [B, T + 1] through models/decoder.
    forward (JAX's loss_fn in train_tiny_lm). The forward writes a fresh
    f32 head-major cache, whose prefill attends over the chunk's own k/v:
    the same values as JAX's attention over its f32 batch-major cache, and
    no tensor that autograd saves is written in place afterwards."""
    from mixq_tpu_torch.models.decoder import forward, lm_head_f32
    from mixq_tpu_torch.models.layers import KVCache

    B, T = tokens.shape[0], tokens.shape[1] - 1
    cache = KVCache.create(cfg.num_hidden_layers, B, T,
                           cfg.num_key_value_heads, cfg.head_dim_,
                           torch.float32, head_major=True,
                           device=tokens.device)
    logits, _ = forward(params, tokens[:, :-1], cache, specs, cfg,
                        head_f32=lm_head_f32(params, specs))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tokens[:, 1:, None].long())
    return nll.mean()


def trainable(params) -> list:
    """The floating-point tensors a training step updates: embedding, head,
    norm scales and the linears' weights (not their unit scales)."""
    out = [params.embed, params.lnf_scale]
    if params.lm_head is not None:
        out.append(params.lm_head)
    for bp in params.blocks:
        out += [bp.ln1_scale, bp.ln2_scale]
        out += [lin.q_weight for lin in (*bp.attn[:4], *bp.mlp[:3])]
    return out


def train_tiny_lm(
    cfg: ModelConfig,
    corpus: np.ndarray,
    steps: int = 400,
    batch: int = 16,
    seq_len: int = 128,
    lr: float = 3e-3,
    seed: int = 0,
    log_every: int = 0,
    device="cuda",
    generator: Optional[torch.Generator] = None,
):
    """Train the decoder on `corpus` with Adam (torch.optim.Adam, whose
    defaults are optax.adam's), as JAX's train_tiny_lm does: FP16-spec
    linears with f32 outputs, the port's random init from `generator`
    (default: seeded with `seed` on `device`) in f32 (the linears stored
    in bf16, as JAX stores them), and JAX's window sampler, so every batch
    is the one JAX draws. Returns (DecoderParams, final loss)."""
    from mixq_tpu_torch.models.decoder import DecoderSpecs, init_decoder_params
    from mixq_tpu_torch.ops.mixed_linear import LinearSpec

    specs = DecoderSpecs.uniform(
        LinearSpec(version="FP16", w_bit=16, out_dtype="float32"))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    params = init_decoder_params(cfg, specs, generator, device=device,
                                 dtype=torch.float32)
    leaves = trainable(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)

    rng = np.random.RandomState(seed + 1)
    n_windows = len(corpus) - (seq_len + 1)
    loss = None
    for step in range(steps):
        starts = rng.randint(0, n_windows, batch)
        tokens = torch.from_numpy(
            np.stack([corpus[s:s + seq_len + 1] for s in starts])).to(device)
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(params, tokens, cfg, specs)
        loss.backward()
        opt.step()
        loss = loss.detach()
        if log_every and (step + 1) % log_every == 0:
            print(f"# substrate train step {step+1}/{steps} "
                  f"loss {float(loss):.4f}", flush=True)
    for t in leaves:
        t.requires_grad_(False)
    return params, float(loss)


def hf_state_from_params(params, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """DecoderParams (FP16 specs) -> HF-llama-style numpy f32 state dict,
    the inverse of models/hf.py::params_from_source for the llama scheme,
    so a trained substrate flows through quantize_model and the engines."""
    def a(t):
        return t.detach().float().cpu().numpy()

    def w(p):           # ours [in, out] -> HF [out, in]
        return np.ascontiguousarray(a(p.q_weight).T)

    d = {
        "model.embed_tokens.weight": a(params.embed),
        "model.norm.weight": a(params.lnf_scale),
    }
    if params.lm_head is not None:
        d["lm_head.weight"] = np.ascontiguousarray(a(params.lm_head).T)
    for i, bp in enumerate(params.blocks):
        p = f"model.layers.{i}."
        d[p + "input_layernorm.weight"] = a(bp.ln1_scale)
        d[p + "post_attention_layernorm.weight"] = a(bp.ln2_scale)
        d[p + "self_attn.q_proj.weight"] = w(bp.attn.wq)
        d[p + "self_attn.k_proj.weight"] = w(bp.attn.wk)
        d[p + "self_attn.v_proj.weight"] = w(bp.attn.wv)
        d[p + "self_attn.o_proj.weight"] = w(bp.attn.wo)
        d[p + "mlp.up_proj.weight"] = w(bp.mlp.up)
        d[p + "mlp.gate_proj.weight"] = w(bp.mlp.gate)
        d[p + "mlp.down_proj.weight"] = w(bp.mlp.down)
    return d


def device_state(state: Dict[str, np.ndarray],
                 device="cuda") -> Dict[str, torch.Tensor]:
    """The dict's arrays as f32 tensors on `device`, one tensor per distinct
    array: the layers of a share_blocks state keep aliasing one set of
    tensors, so a 7B Markov state takes one block's memory on the card and
    params_from_source reads it there without a host copy per layer."""
    from mixq_tpu_torch.convert import tensor_from_numpy

    by_id: Dict[int, torch.Tensor] = {}
    out = {}
    for k, v in state.items():
        if id(v) not in by_id:
            by_id[id(v)] = tensor_from_numpy(
                np.asarray(v, np.float32), device=device)
        out[k] = by_id[id(v)]
    return out


# ---------------------------------------------------------------------------
# Function-preserving outlier planting
# ---------------------------------------------------------------------------

def plant_outlier_channels(
    state: Dict[str, np.ndarray],
    cfg: ModelConfig,
    channels: Sequence[int],
    gain: float = 8.0,
    inner_channels: Optional[Sequence[int]] = None,
) -> Dict[str, np.ndarray]:
    """Make residual-stream `channels` sticky activation outliers without
    changing the fp function: input_layernorm.weight[c] and
    post_attention_layernorm.weight[c] times `gain`, column c of every
    consumer (q/k/v, up/gate) divided by it; `inner_channels` likewise for
    the MLP inner dimension (up_proj output row times gain, down_proj input
    column divided by it). Mutates and returns `state`."""
    g = np.float32(gain)
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        ln1 = state[p + "input_layernorm.weight"]
        ln2 = state[p + "post_attention_layernorm.weight"]
        for c in channels:
            ln1[c] *= g
            ln2[c] *= g
            for name in ("self_attn.q_proj", "self_attn.k_proj",
                         "self_attn.v_proj"):
                state[p + name + ".weight"][:, c] /= g      # HF [out, in]
            for name in ("mlp.up_proj", "mlp.gate_proj"):
                state[p + name + ".weight"][:, c] /= g
        inner = () if inner_channels is None else inner_channels
        for c in inner:
            state[p + "mlp.up_proj.weight"][c, :] *= g      # output channel
            state[p + "mlp.down_proj.weight"][:, c] /= g    # input row
    return state


# ---------------------------------------------------------------------------
# Markov LM at arbitrary (e.g. 7B) shapes
# ---------------------------------------------------------------------------

def make_markov_state(
    cfg: ModelConfig,
    v_eff: int = 512,
    seed: int = 0,
    margin: float = 30.0,
    block_scale: float = 5e-4,
    mean_cycle: int = 48,
    share_blocks: bool = False,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """An HF-style state dict for a cfg-shaped model whose greedy output
    follows a planted first-order Markov chain over tokens [2, v_eff)
    (cycles of ~`mean_cycle` tokens), and the chain's successor table.

    Embedding rows of the chain's tokens are unit gaussians; lm_head solves
    the regularized least squares rmsnorm(embed[t]) @ W ~= margin *
    onehot(succ[t]); the blocks get `block_scale`-scaled random weights, so
    the residual stream stays embedding-dominated. share_blocks: every
    layer maps to the same arrays. Returns (state, succ[v_eff])."""
    rng = np.random.RandomState(seed)
    H, V = cfg.hidden_size, cfg.vocab_size
    assert v_eff <= min(V, H), "readout solve needs v_eff <= hidden_size"

    succ = np.zeros(v_eff, np.int64)
    toks = np.arange(2, v_eff)
    rng.shuffle(toks)
    i = 0
    while i < len(toks):
        n = max(3, int(rng.poisson(mean_cycle)))
        cyc = toks[i:i + n]
        for a, b in zip(cyc, np.roll(cyc, -1)):
            succ[a] = b
        i += n
    succ[0] = succ[1] = 2   # pad/BOS fall into the chain

    embed = (rng.randn(V, H) * 0.02).astype(np.float32)
    E = rng.randn(v_eff, H).astype(np.float32)
    embed[:v_eff] = E
    X = E / np.sqrt((E ** 2).mean(axis=1, keepdims=True) + 1e-5)
    M = np.zeros((v_eff, v_eff), np.float32)
    M[np.arange(v_eff), succ] = margin
    G = X @ X.T + 1e-3 * np.eye(v_eff, dtype=np.float32)
    W = X.T @ np.linalg.solve(G, M)                     # [H, v_eff]
    lm_head = (rng.randn(V, H) * 1e-4).astype(np.float32)  # HF [V, H]
    lm_head[:v_eff] = W.T

    state = {
        "model.embed_tokens.weight": embed,
        "model.norm.weight": np.ones(H, np.float32),
        "lm_head.weight": lm_head,
    }
    I = cfg.intermediate_size
    nq, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                   cfg.head_dim_)
    s = np.float32(block_scale)
    one = {
        "input_layernorm.weight": np.ones(H, np.float32),
        "post_attention_layernorm.weight": np.ones(H, np.float32),
        "self_attn.q_proj.weight": rng.randn(nq * hd, H).astype(
            np.float32) * s,
        "self_attn.k_proj.weight": rng.randn(nkv * hd, H).astype(
            np.float32) * s,
        "self_attn.v_proj.weight": rng.randn(nkv * hd, H).astype(
            np.float32) * s,
        "self_attn.o_proj.weight": rng.randn(H, nq * hd).astype(
            np.float32) * s,
        "mlp.gate_proj.weight": rng.randn(I, H).astype(np.float32) * s,
        "mlp.up_proj.weight": rng.randn(I, H).astype(np.float32) * s,
        "mlp.down_proj.weight": rng.randn(H, I).astype(np.float32) * s,
    }
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        if share_blocks:
            for name, arr in one.items():
                state[p + name] = arr
        else:
            state[p + "input_layernorm.weight"] = np.ones(H, np.float32)
            state[p + "post_attention_layernorm.weight"] = np.ones(
                H, np.float32)
            for name in ("self_attn.q_proj", "self_attn.k_proj",
                         "self_attn.v_proj", "self_attn.o_proj",
                         "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
                shape = one[name + ".weight"].shape
                state[p + name + ".weight"] = rng.randn(*shape).astype(
                    np.float32) * s
    return state, succ
