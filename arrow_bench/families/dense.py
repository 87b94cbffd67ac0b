"""The dense family on the serving program: its configuration from the
benchmark's file, the kernels its engine path builds, and the model
operations of a token (for ``step_mfu``)."""
from __future__ import annotations

REFERENCE = "dense"
KERNELS = ("flash_prefill", "paged_attention")


def model_config(conf: dict):
    """The program's ``ModelConfig`` of ``conf``, on its serving path (the
    hand-written kernels, bf16)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        arch_id=conf["name"], family="dense",
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        activation="swiglu", norm="rmsnorm", rope="standard",
        rope_theta=float(conf["rope_theta"]), qk_norm=True,
        tie_embeddings=conf["tie_word_embeddings"],
        max_seq_len=conf["max_position_embeddings"],
        dtype=conf["torch_dtype"], attn_impl="hopper",
        source=conf["source"])


def attn_shape(conf: dict):
    """(query heads, kv heads, head dim) of the attention kernels."""
    return (conf["num_attention_heads"], conf["num_key_value_heads"],
            conf["head_dim"])


def layer_flops(conf: dict, tokens: int, attended: int) -> float:
    """Model operations of ``tokens`` tokens through every layer, their
    attention reading ``attended`` keys in all (each token its own
    context): the projections, attention's two products and the MLP."""
    d, ff = conf["hidden_size"], conf["intermediate_size"]
    H, Hk, D = attn_shape(conf)
    per_token = 2 * d * (H * D + 2 * Hk * D) + 2 * H * D * d + 6 * d * ff
    return conf["num_hidden_layers"] * (tokens * per_token
                                        + 4.0 * H * D * attended)


def n_layers(conf: dict) -> int:
    return conf["num_hidden_layers"]


def head_flops(conf: dict) -> float:
    """The output head of one sampled position."""
    return 2.0 * conf["hidden_size"] * conf["vocab_size"]
