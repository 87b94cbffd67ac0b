"""Model/architecture configuration dataclasses.

Every assigned architecture gets one ``<arch>.py`` in this package exporting
``CONFIG`` (the full published config) and ``smoke_config()`` (a reduced
variant of the same family for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int          # per-expert FFN hidden size
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD parameters."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64        # SSD head dim P
    chunk: int = 128          # SSD chunk length
    n_groups: int = 1         # B/C groups (G)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma / Griffin: repeating block pattern."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")
    lru_width: Optional[int] = None      # defaults to d_model
    local_window: int = 2048             # local attention window
    conv_width: int = 4                  # temporal conv in recurrent block


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder for enc-dec archs (whisper). Frontend is a stub: input_specs
    provides precomputed frame embeddings of shape (B, n_frames, d_model)."""
    n_layers: int = 24
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str               # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    activation: str = "swiglu"           # swiglu | geglu | gelu
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    rope: str = "standard"               # standard | partial | mrope | none | learned
    rope_fraction: float = 1.0           # fraction of head_dim rotated (chatglm=0.5)
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # qwen2-vl t/h/w halves
    qk_norm: bool = False
    logit_softcap: Optional[float] = None
    embed_scale: bool = False            # gemma: scale embeddings by sqrt(d_model)
    tie_embeddings: bool = True
    max_seq_len: int = 1 << 20
    sliding_window: Optional[int] = None          # always-on local window (hybrid attn)
    long_context_window: Optional[int] = 4096     # window used for the long_500k variant;
                                                  # None => arch cannot run long_500k
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encoder: Optional[EncoderConfig] = None
    dtype: str = "bfloat16"
    # Attention implementation on the dense serving path (DESIGN.md §9):
    # "reference" = plain-torch sdpa with explicit masks; "hopper" = the
    # hand-written flash_prefill / paged_attention CUDA kernels (their
    # plain-torch versions on CPU tensors). The hopper path assumes the
    # serving engine's contiguously-valid KV prefix contract and no
    # logit_softcap.
    attn_impl: str = "reference"
    source: str = ""                     # citation
    # Dry-run only: fully unroll the layer scan so compiled.cost_analysis()
    # and the collective-bytes sum count every layer (XLA reports while-loop
    # bodies once). Training/serving keep the scan (small HLO, fast compile).
    scan_unroll: bool = False
    # Distribution: when set (by the step builders), models pin activations'
    # batch dim to these mesh axes via with_sharding_constraint — without it
    # GSPMD can de-shard the batch after the (vocab-sharded) embedding gather
    # and all-reduce FULL activations every layer (§Perf hillclimb A).
    act_batch_axes: Optional[Tuple[str, ...]] = None
    # §Perf hillclimb: sequence-parallel full-seq attention — shard q's seq
    # dim over this axis and replicate K/V (cheap for MQA/GQA), so scores are
    # computed block-locally with no partial-contraction all-reduce.
    attn_seq_axis: Optional[str] = None
    # §Perf hillclimb C: GShard-style grouped MoE dispatch. moe_groups splits
    # tokens into batch-aligned groups that sort/pack locally; the (G,E,C,d)
    # dispatch buffer is then resharded group-sharded -> expert-sharded on
    # moe_ep_axis, which GSPMD lowers to all-to-all instead of the one-hot
    # gather + 256GiB all-reduce the global-sort dispatch provokes.
    moe_ep_axis: Optional[str] = None
    moe_groups: int = 1

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (for 6ND model-flops accounting).
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.head_dim_
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.activation in ("swiglu", "geglu"):
            mlp_per_ff = 3 * d
        else:
            mlp_per_ff = 2 * d
        n = 0
        if self.family == "moe":
            e = self.moe.top_k if active_only else self.moe.n_experts
            mlp = e * mlp_per_ff * self.moe.d_ff_expert + d * self.moe.n_experts
            n += self.n_layers * (attn + mlp + 2 * d)
        elif self.family == "ssm":
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            # in_proj (z,x,B,C,dt), conv, out_proj
            per = d * (2 * di + 2 * s.n_groups * s.d_state + nh) + s.d_conv * (
                di + 2 * s.n_groups * s.d_state) + di * d + 2 * nh + di
            n += self.n_layers * (per + 2 * d)
        elif self.family == "hybrid":
            h = self.hybrid
            lw = h.lru_width or d
            rec = d * lw * 2 + h.conv_width * lw + lw * d + 2 * lw  # gates are lw*lw? see models
            rec += 2 * lw * lw  # input/recurrent gates
            mlp = mlp_per_ff * ff
            pat = list(h.pattern)
            per_group = sum(rec if p == "rglru" else attn for p in pat) + len(pat) * (mlp + 2 * d)
            n += (self.n_layers // len(pat)) * per_group
        else:
            mlp = mlp_per_ff * ff
            n += self.n_layers * (attn + mlp + 2 * d)
            if self.family == "encdec" and self.encoder is not None:
                # encoder layers + decoder cross-attn
                n += self.encoder.n_layers * (attn + mlp + 2 * d)
                n += self.n_layers * (attn + d)  # cross attention
        n += self.padded_vocab * d  # embedding (tied head)
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        return n


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
