"""whisper-medium [arXiv:2212.04356] — enc-dec audio; conv/mel frontend is a stub
(input_specs supplies precomputed frame embeddings)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    rope="learned",           # whisper uses learned positional embeddings in the decoder
    tie_embeddings=True,
    max_seq_len=448,
    long_context_window=None,  # enc-dec full attention: long_500k skipped (DESIGN.md §4)
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
        vocab_size=512, encoder=EncoderConfig(n_layers=2, n_frames=16), max_seq_len=64,
    )
