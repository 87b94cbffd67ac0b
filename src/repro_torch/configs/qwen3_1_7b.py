"""qwen3-1.7b [hf:Qwen/Qwen3-8B family] — dense, qk_norm, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    rope="standard",
    rope_theta=1000000.0,
    qk_norm=True,
    tie_embeddings=True,
    max_seq_len=32768,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512,
    )
