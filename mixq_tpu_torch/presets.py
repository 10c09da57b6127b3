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
