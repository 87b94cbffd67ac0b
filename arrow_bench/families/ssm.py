"""The ssm (Mamba-2) family on the serving program: its configuration from
the benchmark's file, the kernels its engine path builds, and the model
operations of a token (for ``step_mfu``)."""
from __future__ import annotations

REFERENCE = "ssm"
KERNELS = ("ssd_scan",)


def model_config(conf: dict):
    """The program's ``ModelConfig`` of ``conf``, on its serving path (the
    ``ssd_scan`` kernel, bf16). ``ssm_chunk`` is the scan's chunk, an
    execution parameter (the kernel's tiles hold at most 128)."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    s = conf["ssm_cfg"]
    return ModelConfig(
        arch_id=conf["name"], family="ssm", n_layers=conf["n_layer"],
        d_model=conf["d_model"], n_heads=0, n_kv_heads=0,
        head_dim=s["headdim"], d_ff=0, vocab_size=conf["vocab_size"],
        norm="rmsnorm", rope="none", tie_embeddings=conf["tie_embeddings"],
        long_context_window=None,
        ssm=SSMConfig(d_state=s["d_state"], d_conv=s["d_conv"],
                      expand=s["expand"], head_dim=s["headdim"],
                      chunk=conf["ssm_chunk"], n_groups=s["ngroups"]),
        dtype=conf["torch_dtype"], attn_impl="hopper",
        source=conf["source"])


def scan_shape(conf: dict):
    """(heads, head dim, state size, groups, chunk) of ``ssd_scan``."""
    s = conf["ssm_cfg"]
    di = s["expand"] * conf["d_model"]
    return (di // s["headdim"], s["headdim"], s["d_state"], s["ngroups"],
            conf["ssm_chunk"])


def layer_flops(conf: dict, tokens: int, attended: int) -> float:
    """Model operations of ``tokens`` tokens through every layer (the
    recurrence's cost does not depend on the context, so ``attended`` is
    unused): the projections, the convolution, the state update and its
    read-out."""
    del attended
    d = conf["d_model"]
    H, P, N, G, _ = scan_shape(conf)
    di = H * P
    W = conf["ssm_cfg"]["d_conv"]
    per_token = (2 * d * (2 * di + 2 * G * N + H) + 2 * W * (di + 2 * G * N)
                 + 4 * H * P * N + 2 * di * d)
    return conf["n_layer"] * tokens * float(per_token)


def n_layers(conf: dict) -> int:
    return conf["n_layer"]


def head_flops(conf: dict) -> float:
    """The output head of one sampled position."""
    return 2.0 * conf["d_model"] * conf["vocab_size"]
