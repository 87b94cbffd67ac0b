"""olmoe-1b-7b [arXiv:2409.02060] — MoE, 64 experts top-8, small experts."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    activation="swiglu",
    norm="rmsnorm",
    rope="standard",
    qk_norm=True,
    tie_embeddings=False,
    max_seq_len=4096,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    source="arXiv:2409.02060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=64,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=4.0),
    )
