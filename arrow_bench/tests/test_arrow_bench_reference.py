"""The plain float32 references against the program's plain model path at
a smoke width, the chunked SSD against the step-by-step recurrence, and the
float8 control against float32."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from arrow_bench.bench import load_module
from arrow_bench.tests.conftest import TINY_DENSE, TINY_SSM

BENCH = Path(__file__).resolve().parents[1]
dense_ref = load_module(BENCH / "reference" / "dense.py", "t_ref_dense")
ssm_ref = load_module(BENCH / "reference" / "ssm.py", "t_ref_ssm")


def program_logits(fam_file, conf, params, tokens):
    fam = load_module(BENCH / "families" / fam_file, f"t_{fam_file}")
    cfg = fam.model_config(conf).replace(attn_impl="reference")
    from repro_torch.models import dense, ssm
    model = dense if cfg.family == "dense" else ssm
    x = model.embed_tokens(cfg, params, torch.as_tensor(tokens)[None])
    logits, _ = model.forward_seq(cfg, params, x,
                                  torch.arange(len(tokens)))
    return logits[0, :, :conf["vocab_size"]]


@pytest.mark.parametrize("fam,conf,ref", [
    ("dense.py", TINY_DENSE, dense_ref), ("ssm.py", TINY_SSM, ssm_ref)])
def test_reference_matches_the_program_in_float32(fam, conf, ref):
    torch.manual_seed(0)
    params = ref.init_weights(conf, 3, "cpu")
    for k, v in params.items():       # norm scales away from 1 as well
        if k.endswith(("scale", "norm")):
            v.normal_(0.0, 0.1)
    tokens = np.random.default_rng(0).integers(1, conf["vocab_size"], 80)
    want = program_logits(fam, conf, params, tokens)
    pos = [0, 17, 40, 79]
    got = ref.logits_at(conf, params, tokens, pos)
    assert torch.allclose(got, want[pos].float(), atol=2e-4, rtol=1e-4)


def test_chunked_ssd_equals_the_recurrence():
    g = torch.Generator().manual_seed(1)
    T, H, P, G, N = 37, 4, 3, 2, 5
    x = torch.randn(T, H, P, generator=g)
    dt = torch.rand(T, H, generator=g)
    A = -torch.rand(H, generator=g) - 0.1
    B = torch.randn(T, G, N, generator=g)
    C = torch.randn(T, G, N, generator=g)
    y = ssm_ref.ssd(x, dt, A, B, C, chunk=8)
    h = torch.zeros(H, P, N)
    grp = torch.arange(H) // (H // G)
    for t in range(T):
        h = torch.exp(dt[t] * A)[:, None, None] * h + \
            dt[t][:, None, None] * x[t][:, :, None] * B[t][grp][:, None, :]
        assert torch.allclose(y[t], (h * C[t][grp][:, None, :]).sum(-1),
                              atol=1e-5)


def test_control_is_float8():
    conf = dict(TINY_DENSE, vocab_size=512)
    params = dense_ref.init_weights(conf, 4, "cpu")
    tokens = np.arange(1, 40)
    a = dense_ref.logits_at(conf, params, tokens, [38])
    b = dense_ref.logits_at(conf, params, tokens, [38], precision="fp8")
    err = (a - b).abs().max().item()
    assert 1e-4 < err < 0.5 * a.abs().max().item()


def test_configurations_have_the_published_widths():
    q = json.loads((BENCH / "configs" / "qwen3-1.7b.json").read_text())
    assert (q["num_hidden_layers"], q["hidden_size"], q["num_attention_heads"],
            q["num_key_value_heads"], q["head_dim"], q["intermediate_size"],
            q["vocab_size"]) == (28, 2048, 16, 8, 128, 6144, 151936)
    m = json.loads((BENCH / "configs" / "mamba2-370m.json").read_text())
    assert (m["n_layer"], m["d_model"], m["ssm_cfg"]["d_state"],
            m["ssm_cfg"]["expand"], m["ssm_cfg"]["headdim"]) == \
        (48, 1024, 128, 2, 64)
