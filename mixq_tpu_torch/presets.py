"""Full-size model configurations the port serves, each from its published
config (all layers): the shapes chip_smoke.py and the example scripts run.
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
