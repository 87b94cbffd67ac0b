"""stablelm-12b [hf:stabilityai/stablelm-2-1_6b] — dense, partial RoPE, GQA kv=8."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    activation="swiglu",
    norm="layernorm",
    rope="partial",
    rope_fraction=0.25,
    tie_embeddings=False,
    max_seq_len=4096,
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512,
    )
