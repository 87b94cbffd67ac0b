"""chatglm3-6b [arXiv:2406.12793] — dense, 2d (partial) RoPE, GQA kv=2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    activation="swiglu",
    norm="rmsnorm",
    rope="partial",
    rope_fraction=0.5,        # 2d rope: rotate half of head_dim
    tie_embeddings=False,
    max_seq_len=32768,
    source="arXiv:2406.12793",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512,
    )
