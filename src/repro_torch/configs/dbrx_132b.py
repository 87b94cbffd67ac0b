"""dbrx-132b [hf:databricks/dbrx-base] — fine-grained MoE, 16 experts top-4."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    activation="swiglu",
    norm="rmsnorm",
    rope="standard",
    rope_theta=500000.0,
    tie_embeddings=False,
    max_seq_len=32768,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=512,
        # capacity_factor >= E/K makes dispatch drop-free so decode==prefill exactly
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, capacity_factor=4.0),
    )
