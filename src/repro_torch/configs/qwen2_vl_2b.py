"""qwen2-vl-2b [arXiv:2409.12191] — VLM; M-RoPE; vision encoder is a stub
(input_specs supplies pre-projected patch+text embeddings and M-RoPE positions)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    rope="mrope",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),   # halves of head_dim/2 split across (t, h, w)
    tie_embeddings=True,
    max_seq_len=32768,
    source="arXiv:2409.12191",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=512, mrope_sections=(4, 6, 6), max_seq_len=128,
    )
