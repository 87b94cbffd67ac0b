"""mamba2-370m [arXiv:2405.21060] — attention-free SSM, SSD (state-space duality)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                # attention-free
    n_kv_heads=0,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    norm_eps=1e-5,              # mamba_ssm's RMSNorm and gated RMSNorm
    residual_in_fp32=True,      # the published config.json
    rope="none",
    tie_embeddings=True,
    long_context_window=None,   # not needed: state is O(1) in sequence length
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128, n_groups=1),
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    """The JAX package's smoke config, its norm eps and residual dtype
    included (the parity tests compare the two packages at it)."""
    return CONFIG.replace(
        n_layers=2, d_model=128, vocab_size=512, norm_eps=1e-6,
        residual_in_fp32=False,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16, n_groups=1),
    )
