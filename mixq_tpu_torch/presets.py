"""Full-size model configurations the port serves, each from its published
config (all layers): the shapes chip_smoke.py and the example scripts run.
The field values are copied from each model's published config.json.
"""
from mixq_tpu_torch.config import ModelConfig


def llama2_7b() -> ModelConfig:
    """Llama-2-7B (bench.py:54-65)."""
    return ModelConfig(model_type="llama", vocab_size=32000, hidden_size=4096,
                       intermediate_size=11008, num_hidden_layers=32,
                       num_attention_heads=32, num_key_value_heads=32,
                       max_position_embeddings=4096)


def gemma2_9b() -> ModelConfig:
    """The published config.json of google/gemma-2-9b, in the form
    mixq_tpu/models/hf.py:202-223 gives it."""
    return ModelConfig(
        model_type="gemma2", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_hidden_layers=42,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256,
        rms_norm_eps=1e-6, rope_theta=10000.0,
        hidden_act="gelu_pytorch_tanh", gated_mlp=True,
        tie_word_embeddings=True, embed_multiplier=3584 ** 0.5,
        post_norms=True, query_pre_attn_scalar=256.0,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        sliding_window=4096, sliding_window_pattern=2,
        max_position_embeddings=8192)


def baichuan_13b() -> ModelConfig:
    """The published config.json of baichuan-inc/Baichuan-13B-Base through
    models.hf.config_from_hf (JAX's rule, mixq_tpu/models/hf.py:177-200:
    40 layers give ALiBi and rope style "none")."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="baichuan", vocab_size=64000, hidden_size=5120,
        intermediate_size=13696, num_hidden_layers=40,
        num_attention_heads=40, model_max_length=4096, rms_norm_eps=1e-6,
        hidden_act="silu", tie_word_embeddings=False))


def mistral_7b() -> ModelConfig:
    """The published config.json of mistralai/Mistral-7B-v0.1, in the form
    mixq_tpu/models/hf.py:185-201 gives it."""
    return ModelConfig(
        model_type="mistral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False,
        sliding_window=4096, max_position_embeddings=32768)


def llama31_8b() -> ModelConfig:
    """The published config.json of meta-llama/Llama-3.1-8B through
    models.hf.config_from_hf: 32/8 heads, theta 5e5, llama3 rope scaling
    (factor 8, low 1, high 4, original context 8192)."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="llama", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0, hidden_act="silu", attention_bias=False,
        mlp_bias=False, tie_word_embeddings=False,
        rope_scaling={"factor": 8.0, "low_freq_factor": 1.0,
                      "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192,
                      "rope_type": "llama3"}))


def qwen25_7b() -> ModelConfig:
    """The published config.json of Qwen/Qwen2.5-7B through
    models.hf.config_from_hf: 28/4 heads (g = 7), q/k/v bias, theta 1e6,
    no sliding window (use_sliding_window false)."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="qwen2", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=131072, rms_norm_eps=1e-6,
        rope_theta=1000000.0, hidden_act="silu", sliding_window=131072,
        use_sliding_window=False, max_window_layers=28,
        tie_word_embeddings=False))


def qwen3_8b() -> ModelConfig:
    """The published config.json of Qwen/Qwen3-8B through
    models.hf.config_from_hf: 32/8 heads of 128, QK-norm, theta 1e6."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="qwen3", vocab_size=151936, hidden_size=4096,
        intermediate_size=12288, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        max_position_embeddings=40960, rms_norm_eps=1e-6,
        rope_theta=1000000, rope_scaling=None, hidden_act="silu",
        attention_bias=False, sliding_window=None, use_sliding_window=False,
        max_window_layers=36, tie_word_embeddings=False))


def phi3_mini_4k() -> ModelConfig:
    """The published config.json of microsoft/Phi-3-mini-4k-instruct
    through models.hf.config_from_hf: 32/32 heads of 96, packed q/k/v and
    gate/up weights, a 2047-position sliding window, no rope scaling."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="phi3", vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096, original_max_position_embeddings=4096,
        rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
        sliding_window=2047, hidden_act="silu", attention_bias=False,
        tie_word_embeddings=False))


def gemma_7b() -> ModelConfig:
    """The published config.json of google/gemma-7b through
    models.hf.config_from_hf: 16/16 heads of 256, hidden_act "gelu" (the
    exact GELU, by JAX's rule), sqrt(3072) embedding scale, a tied head."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="gemma", vocab_size=256000, hidden_size=3072,
        intermediate_size=24576, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=16, head_dim=256,
        max_position_embeddings=8192, rms_norm_eps=1e-6, rope_theta=10000.0,
        rope_scaling=None, hidden_act="gelu", attention_bias=False))


def falcon_7b() -> ModelConfig:
    """The published config.json of tiiuae/falcon-7b through
    models.hf.config_from_hf: 71 query heads of 64 on one kv head
    (multi_query: g = 71), H=4544, the parallel block with one shared
    LayerNorm, a GELU MLP of 4 x H, rotary (alibi false), no biases."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="falcon", vocab_size=65024, hidden_size=4544,
        num_hidden_layers=32, num_attention_heads=71, multi_query=True,
        new_decoder_architecture=False, parallel_attn=True, alibi=False,
        bias=False, layer_norm_epsilon=1e-5, bos_token_id=11,
        eos_token_id=11))


def starcoder2_7b() -> ModelConfig:
    """The published config.json of bigcode/starcoder2-7b through
    models.hf.config_from_hf: 36/4 heads of 128 (g = 9), H=4608,
    I=18432, LayerNorm and biases everywhere (use_bias), a
    gelu_pytorch_tanh MLP, theta 1e6, its 4096 sliding_window not used
    (no use_sliding_window: JAX's rule)."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="starcoder2", vocab_size=49152, hidden_size=4608,
        intermediate_size=18432, num_hidden_layers=32,
        num_attention_heads=36, num_key_value_heads=4,
        max_position_embeddings=16384, norm_epsilon=1e-5,
        rope_theta=1000000, hidden_act="gelu_pytorch_tanh",
        sliding_window=4096, use_bias=True, norm_type="layer_norm",
        mlp_type="default"))


def gptj_6b() -> ModelConfig:
    """The published config.json of EleutherAI/gpt-j-6b through
    models.hf.config_from_hf: 16 heads of 256, H=4096, 28 layers, the
    parallel block, gptj-style RoPE on 64 of each head's 256 values,
    gelu_new, n_inner null (4 x H)."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="gptj", vocab_size=50400, n_embd=4096, n_layer=28,
        n_head=16, n_inner=None, n_positions=2048, rotary_dim=64,
        activation_function="gelu_new", layer_norm_epsilon=1e-5,
        tie_word_embeddings=False))


def opt_6_7b() -> ModelConfig:
    """The published config.json of facebook/opt-6.7b through
    models.hf.config_from_hf: 32 heads of 128, H=4096, ffn_dim 16384,
    learned positions (2048), relu, LayerNorm before each sublayer."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="opt", vocab_size=50272, hidden_size=4096,
        ffn_dim=16384, num_hidden_layers=32, num_attention_heads=32,
        max_position_embeddings=2048, activation_function="relu",
        do_layer_norm_before=True, word_embed_proj_dim=4096))


def chatglm3_6b() -> ModelConfig:
    """The published config.json of THUDM/chatglm3-6b through
    models.hf.config_from_hf: 32 heads of 128 in 2 multi-query groups
    (g = 16), H=4096, ffn_hidden_size 13696 (SwiGLU), RMSNorm, gptj-style
    RoPE on half of kv_channels 128, q/k/v bias (add_qkv_bias),
    padded_vocab_size 65024. The config names its depth `num_layers` and
    its context `seq_length`, which JAX's mapping does not read (it gives
    32 layers and 4096 positions; ROADMAP.md Queue C): the preset sets
    them from those fields."""
    import dataclasses

    from mixq_tpu_torch.models.hf import config_from_hf

    hf = dict(model_type="chatglm", padded_vocab_size=65024,
              hidden_size=4096, ffn_hidden_size=13696, kv_channels=128,
              num_layers=28, num_attention_heads=32,
              multi_query_attention=True, multi_query_group_num=2,
              layernorm_epsilon=1e-5, rmsnorm=True, add_qkv_bias=True,
              add_bias_linear=False, seq_length=8192,
              tie_word_embeddings=False)
    return dataclasses.replace(config_from_hf(hf),
                               num_hidden_layers=hf["num_layers"],
                               max_position_embeddings=hf["seq_length"])


def mixtral_8x7b() -> ModelConfig:
    """The published config.json of mistralai/Mixtral-8x7B-v0.1 through
    models.hf.config_from_hf: 32 layers, H=4096, 32/8 heads of 128, 8
    experts of I=14336, top-2 (renormalised), theta 1e6, no sliding
    window, untied head."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="mixtral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rms_norm_eps=1e-5,
        rope_theta=1000000.0, hidden_act="silu", sliding_window=None,
        num_local_experts=8, num_experts_per_tok=2,
        tie_word_embeddings=False))


def qwen1_5_moe_a2_7b() -> ModelConfig:
    """The published config.json of Qwen/Qwen1.5-MoE-A2.7B through
    models.hf.config_from_hf: 24 layers, H=2048, 16/16 heads of 128, q/k/v
    bias, 60 experts of moe_intermediate_size 1408, top-4 without
    renormalisation (norm_topk_prob false), a shared expert of 5632 (its
    width comes from the weights; no config field holds it), theta 1e6,
    untied head."""
    from mixq_tpu_torch.models.hf import config_from_hf

    return config_from_hf(dict(
        model_type="qwen2_moe", vocab_size=151936, hidden_size=2048,
        intermediate_size=5632, moe_intermediate_size=1408,
        shared_expert_intermediate_size=5632, num_hidden_layers=24,
        num_attention_heads=16, num_key_value_heads=16,
        max_position_embeddings=8192, rms_norm_eps=1e-6,
        rope_theta=1000000.0, hidden_act="silu", sliding_window=32768,
        use_sliding_window=False, max_window_layers=21,
        decoder_sparse_step=1, num_experts=60, num_experts_per_tok=4,
        norm_topk_prob=False, tie_word_embeddings=False))
