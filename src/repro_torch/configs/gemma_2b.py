"""gemma-2b [arXiv:2403.08295] — dense, GeGLU, head_dim=256, MQA (kv=1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    rope="standard",
    rope_theta=10000.0,
    embed_scale=True,
    tie_embeddings=True,
    max_seq_len=8192,
    source="arXiv:2403.08295",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=512,
        vocab_size=512, max_seq_len=128,
    )
