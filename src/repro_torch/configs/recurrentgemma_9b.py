"""recurrentgemma-9b [arXiv:2402.19427] — hybrid: RG-LRU + local attention, 1:2."""
from repro_torch.configs.base import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,              # 38 blocks; pattern (rglru, rglru, attn) — final partial group
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    rope="standard",
    embed_scale=True,
    tie_embeddings=True,
    sliding_window=2048,      # local attention window (always on)
    long_context_window=2048,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"), lru_width=4096,
                        local_window=2048, conv_width=4),
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256,
        vocab_size=512, sliding_window=32,
        hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"), lru_width=128,
                            local_window=32, conv_width=4),
    )
