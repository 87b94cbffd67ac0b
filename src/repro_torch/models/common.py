"""Shared building blocks of the model families, in PyTorch: norms, RoPE
(standard, partial and M-RoPE), sinusoidal positions, the reference GQA
attention, masks, the attention projections, MLPs, the (un)embedding and
the language-model loss, and the distribution hooks.

Every function is a plain function on tensors. Parameters are a flat dict
keyed by the JAX pytree's ``a/b/c`` paths (see :mod:`repro_torch.weights`);
the functions here receive one layer's slice of it, keyed by the path below
``layers/`` (``"attn/wq"``, ``"ln1/scale"``, ...). Norms and softmaxes run
in float32 and cast back, as the JAX package does.

On DTensor inputs (the step builders of :mod:`repro_torch.distributed`) the
same functions run sharded. :func:`constrain_batch` and
:func:`constrain_seq_attention` are the JAX package's sharding hooks, each
a ``redistribute`` (a no-op on plain tensors and when the config does not
ask). Attention runs on each rank's local heads, batch rows, query block
or cache block (:func:`on_shards`), as do the embedding gather over a
vocabulary-split table, the loss over vocabulary-split logits and the
cache writes; a row-split product's pending sum is reduced at once
(:func:`settled`). Tensors made inside the model (RoPE tables, masks,
positions) are plain, and the steps run under ``implicit_replication`` so
they enter as replicated DTensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30

# ---------------------------------------------------------------------- norm


def settled(x):
    """A DTensor with a pending sum (a ``Partial`` placement) reduced to a
    replicated one: an all-reduce, whose backward hands the producer a
    replicated gradient (Megatron's row-parallel reduction). A norm needs
    the whole value; left pending, DTensor would carry the sum into the
    next product and a partial gradient into the backward, and gather the
    product's weight whole to meet it."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return _Settled.apply(x)


def _unpartial(placements):
    return [Replicate() if p.is_partial() else p for p in placements]


class _Settled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.redistribute(x.device_mesh, _unpartial(x.placements))

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, _unpartial(g.placements))
        return g


def rms_norm(x, w, eps=1e-6):
    x = settled(x)
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def layer_norm(x, w, b, eps=1e-5):
    x = settled(x)
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def apply_norm(cfg: ModelConfig, p, prefix: str, x):
    """``p`` holds ``<prefix>/scale`` (and ``<prefix>/bias`` for layernorm)."""
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p[f"{prefix}/scale"], cfg.norm_eps)
    return layer_norm(x, p[f"{prefix}/scale"], p[f"{prefix}/bias"])


# ---------------------------------------------------------------------- rope


def rope_angles(positions, rope_dim: int, theta: float):
    """positions (..., S) -> cos,sin (..., S, rope_dim//2), float32."""
    half = rope_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rope_dim: int):
    """x (B, S, H, D); cos/sin broadcastable to (B, S, 1, rope_dim//2)."""
    half = rope_dim // 2
    xr, xp = x[..., :rope_dim], x[..., rope_dim:]
    x1f, x2f = xr[..., :half].float(), xr[..., half:].float()
    r1 = x1f * cos - x2f * sin
    r2 = x2f * cos + x1f * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), xp], dim=-1)


def mrope_angles(positions, rope_dim: int, theta: float, sections):
    """qwen2-vl M-RoPE. positions (B, 3, S) (t/h/w); sections sum to
    rope_dim//2. Frequency channel j takes its position from the section
    it belongs to. -> cos, sin (B, S, rope_dim//2), float32."""
    half = rope_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    dev = positions.device
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=dev) / half))
    # built on the host: repeat_interleave's size would be read off the card
    sec_ids = torch.tensor([i for i, n in enumerate(sections)
                            for _ in range(n)], device=dev)
    pos = positions.float()[:, sec_ids, :]                  # (B, half, S)
    ang = pos.movedim(1, -1) * inv                          # (B, S, half)
    return torch.cos(ang), torch.sin(ang)


def rope_for(cfg: ModelConfig, positions, mrope_positions=None):
    """(cos, sin, rope_dim) ready for :func:`apply_rope`, or (None, None, 0).
    M-RoPE (the VLM family) takes its (B, 3, S) positions from
    ``mrope_positions`` and ignores ``positions``."""
    hd = cfg.head_dim_
    if cfg.rope in ("none", "learned"):
        return None, None, 0
    if cfg.rope == "mrope":
        cos, sin = mrope_angles(mrope_positions, hd, cfg.rope_theta,
                                cfg.mrope_sections)
        return cos[:, :, None, :], sin[:, :, None, :], hd
    rope_dim = hd if cfg.rope == "standard" else int(hd * cfg.rope_fraction)
    rope_dim -= rope_dim % 2
    cos, sin = rope_angles(positions, rope_dim, cfg.rope_theta)
    # positions (S,) -> (1,S,1,half); (B,S) -> (B,S,1,half)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    return cos[:, :, None, :], sin[:, :, None, :], rope_dim


def sinusoidal_positions(n: int, d: int, device=None):
    """(n, d) float32: sin over the first d/2 channels, cos over the rest
    (the encoder's fixed positions)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------------- attention


def sdpa(q, k, v, mask, logit_softcap: Optional[float] = None):
    """Reference GQA attention. q (B,S,H,D); k,v (B,T,Hk,D); mask additive,
    broadcastable to (B,Hk,G,S,T). Returns (B,S,H*D) in q's dtype. On
    DTensors it runs on each rank's shards (:func:`on_shards`)."""
    if isinstance(q, DTensor):
        return on_shards(_sdpa, q, k, v, mask, logit_softcap=logit_softcap)
    return _sdpa(q, k, v, mask, logit_softcap)


def _sdpa(q, k, v, mask, logit_softcap, split=()):
    """:func:`sdpa` on tensors; with ``split`` (the mesh groups a cache's
    sequence is split over) each rank attends to its block of the keys
    and the blocks meet in a max and two sums over those groups
    (flash-decoding)."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qg = q.reshape(B, S, Hk, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) \
        * (1.0 / math.sqrt(D))
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    if not split:
        p = torch.softmax(scores + mask, dim=-1)
        o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    else:
        scores = scores + mask
        m = all_reduce(scores.amax(dim=-1, keepdim=True), "max", split)
        p = torch.exp(scores - m)
        den = all_reduce(p.sum(dim=-1, keepdim=True), "sum", split)
        o = all_reduce(torch.einsum("bkgst,btkd->bskgd", p, v.float()),
                       "sum", split) / den.permute(0, 3, 1, 2, 4)
    return o.reshape(B, S, H * D).to(q.dtype)


def all_reduce(t, op: str, groups):
    """``t`` reduced (``op`` "sum" or "max") over each (mesh, dim) group in
    turn, on local tensors. Its result is used replicated, so the gradient
    of a sum passes through unchanged."""
    if not groups:
        return t
    if op == "sum" and torch.is_grad_enabled() and t.requires_grad:
        return _SumOver.apply(t, groups)
    from torch.distributed import _functional_collectives as funcol
    for g in groups:
        t = funcol.all_reduce(t, op, g)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups):
        with torch.no_grad():
            return all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def on_shards(fn, q, k, v, mask, **kw):
    """Attention on DTensors as ``fn(q, k, v, mask, split=..., **kw)`` on
    each rank's local tensors, through ``local_map``; ``mask`` (or a
    per-row tensor in its place, or None) is split as a mask whose leading
    axis is the batch. Per mesh dim, from the placements q and k arrive
    with:

      k's sequence split (a cache sharded on it)  q replicated, k/v/mask
          split on the key axis; ``fn`` combines the blocks (``split``)
      q's sequence split (``constrain_seq_attention``)  k/v replicated,
          the mask split on the query axis
      batch split on q or k                        all split on batch
      q's heads split (H and Hk divide it)         k/v split on heads
          (k/v heads replicated: each rank gathers the kv heads of its
          own query heads)
      anything else                                all replicated

    The output (B,S,H*D) is split as q is (heads on the last axis; query
    blocks are turned back into heads)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    B, S, H, _ = q.shape
    Hk = k.shape[2]
    R = Replicate()
    if mask is not None and not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, (R,) * mesh.ndim,
                                  run_check=False)
    mask_pl = mask.placements if mask is not None else (None,) * mesh.ndim
    ins, outs, split, head_dim = [], [], [], None
    grads = []                 # in placements whose gradient is a partial sum
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if n == 1:
            # one rank along this dim holds it all: no redistribution
            ins.append((pq, pk, v.placements[i], mask_pl[i]))
            outs.append(R)
            continue
        mshape = mask.shape if mask is not None else (1, 1)
        if pk == Shard(1):
            row = (R, Shard(1), Shard(len(mshape) - 1), R)
            split.append((mesh, i))
            grads.append((i, "q"))
        elif pq == Shard(1):
            row = (Shard(1), R, Shard(len(mshape) - 2)
                   if mshape[-2] == S else R, Shard(1))
            grads.append((i, "kv"))
        elif Shard(0) in (pq, pk):
            row = (Shard(0), Shard(0), Shard(0) if mshape[0] == B
                   else R, Shard(0))
        elif pq == Shard(2) and H % n == 0 and head_dim is None:
            head_dim = i
            kp = Shard(2) if pk == Shard(2) and Hk % n == 0 else R
            row = (Shard(2), kp, R, Shard(2))
            if kp == R:
                grads.append((i, "kv"))
        else:
            row = (R, R, R, R)
        ins.append((row[0], row[1], row[1],
                    row[2] if mask is not None else None))
        outs.append(row[3])
    spread = head_dim is not None and ins[head_dim][1] == R and H != Hk
    # each rank's backward gives the replicated inputs it read a part of
    # (q against a key block; k/v against a query block or head group)
    # only its own share of their gradient
    cols = [list(c) for c in zip(*ins)]
    gcols = [list(c) for c in cols]
    for i, which in grads:
        for j in ((0,) if which == "q" else (1, 2)):
            gcols[j][i] = Partial()

    def local(q, k, v, mask):
        if spread:
            # this rank's query heads, each with its own kv head
            n = mesh.size(head_dim)
            Hl = H // n
            h0 = mesh.get_local_rank(head_dim) * Hl
            idx = (h0 + torch.arange(Hl, device=q.device)) // (H // Hk)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        return fn(q, k, v, mask, split=split, **kw)

    cols = [tuple(c) for c in cols]
    gcols = [tuple(c) for c in gcols]
    if mask is None:
        cols[3] = gcols[3] = None
    o = local_map(local, out_placements=outs, in_placements=tuple(cols),
                  in_grad_placements=tuple(gcols), device_mesh=mesh,
                  redistribute_inputs=True)(q, k, v, mask)
    if Shard(1) in outs:
        # query blocks back to head groups (an all-to-all): the output
        # projection's input split
        o = o.redistribute(mesh, [
            (Shard(2) if o.shape[2] % mesh.size(i) == 0 else Replicate())
            if p == Shard(1) else p for i, p in enumerate(outs)])
    return o


def on_rows(fn, acts, consts, n_out: int):
    """``fn(*acts, *consts)`` on each rank's batch rows, through
    ``local_map``: every tensor of ``acts`` (batch-leading) split on its
    batch over the mesh dims the first one is split on batch, replicated
    over the others; ``consts`` (weights) replicated, each rank's gradient
    its rows' share. The ``n_out`` outputs come out split as ``acts``."""
    from torch.distributed.tensor.experimental import local_map
    lead = acts[0]
    mesh, R = lead.device_mesh, Replicate()
    act, const, grad = [], [], []
    for i, p in enumerate(lead.placements):
        if mesh.size(i) == 1:
            act.append(R)
            const.append(R)
            grad.append(R)
        elif p == Shard(0):
            act.append(p)
            const.append(R)
            grad.append(Partial())
        else:
            act.append(R)
            const.append(R)
            grad.append(R)
    act, const, grad = tuple(act), tuple(const), tuple(grad)
    na, nc = len(acts), len(consts)
    return local_map(fn, out_placements=(act,) * n_out,
                     in_placements=(act,) * na + (const,) * nc,
                     in_grad_placements=(act,) * na + (grad,) * nc,
                     device_mesh=mesh, redistribute_inputs=True)(
                         *acts, *consts)


def _additive(ok):
    return torch.where(ok, 0.0, NEG_INF).float()


def causal_mask(S: int, T: int, q_offset=0, window: Optional[int] = None,
                device=None):
    """(1,1,1,S,T) additive mask; query i sits at q_offset+i, kv j at j."""
    qpos = torch.arange(S, device=device)[:, None] + q_offset
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return _additive(ok)[None, None, None]


def decode_mask(kv_positions, pos, window: Optional[int] = None):
    """kv_positions (B,T) absolute position per cache slot (-1 empty);
    pos (B,) current query position. -> (B,1,1,1,T)."""
    ok = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        ok &= kv_positions > (pos[:, None] - window)
    return _additive(ok)[:, None, None, None]


def chunk_mask(kv_positions, q_positions, window: Optional[int] = None):
    """Chunked-prefill mask: queries at q_positions (Sq,) attend to cache
    slots whose pos_map (B,T) entry is valid and causal. -> (B,1,1,Sq,T)."""
    kv = kv_positions[:, None, :]
    q = q_positions[None, :, None]
    ok = (kv >= 0) & (kv <= q)
    if window is not None:
        ok &= kv > (q - window)
    return _additive(ok)[:, None, None]


# ----------------------------------------------------------- attention block


def split_heads(t, n: int, hd: int):
    """(B,S,n*hd) -> (B,S,n,hd). A DTensor split on its last axis over a
    mesh dim that ``n`` does not divide is gathered along that dim first
    (DTensor cannot unflatten it)."""
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        want = [Replicate() if p == Shard(t.ndim - 1) and n % mesh.size(i)
                else p for i, p in enumerate(t.placements)]
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
    return t.reshape(*t.shape[:-1], n, hd)


def attention_qkv(cfg: ModelConfig, p, x, cos, sin, rope_dim,
                  prefix: str = "attn"):
    """Project + rope. x (B,S,d) -> q (B,S,H,D), k,v (B,S,Hk,D); ``p``
    holds ``<prefix>/wq`` ... (``self_attn``, ``cross_attn`` in the
    encoder-decoder)."""
    hd = cfg.head_dim_
    q = split_heads(x @ p[f"{prefix}/wq"], cfg.n_heads, hd)
    k = split_heads(x @ p[f"{prefix}/wk"], cfg.n_kv_heads, hd)
    v = split_heads(x @ p[f"{prefix}/wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p[f"{prefix}/q_norm"])
        k = rms_norm(k, p[f"{prefix}/k_norm"])
    if rope_dim:
        q = apply_rope(q, cos, sin, rope_dim)
        k = apply_rope(k, cos, sin, rope_dim)
    return q, k, v


# ----------------------------------------------------------------------- mlp


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(cfg: ModelConfig, p, x):
    """The MLP; on DTensors its row-split down projection is reduced at
    once (:func:`settled`)."""
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["mlp/w_gate"]) * (x @ p["mlp/w_up"])
    elif cfg.activation == "geglu":
        h = _gelu(x @ p["mlp/w_gate"]) * (x @ p["mlp/w_up"])
    else:
        return settled(_gelu(x @ p["mlp/w_in"]) @ p["mlp/w_out"])
    return settled(h @ p["mlp/w_down"])


# ------------------------------------------------- recurrent-family helpers


def softplus(x):
    """``jax.nn.softplus`` (logaddexp(x, 0)); torch's F.softplus switches
    to the identity above a threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv(full, w, b, S: int):
    """Depthwise causal conv of ``full`` (B, S+W-1, Ch) with taps w (W, Ch)
    -> (B, S, Ch), summed tap by tap in the input dtype as the JAX package
    does."""
    out = 0
    for i in range(w.shape[0]):
        out = out + full[:, i:i + S] * w[i]
    return out + b


def run_layer(remat: bool, fn, *args):
    """``fn(*args)``; under ``remat`` its activations are recomputed in the
    backward pass instead of kept (``jax.checkpoint`` of a layer body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def write_slots(dst, src, slot, bidx) -> None:
    """dst[bidx, slot] = src in place: dst (B,C,...), src (B,...), slot and
    bidx = arange(B) (B,) integer. On DTensors each rank writes its own
    rows into its block of dst; a dst split on C takes only the rows whose
    slot falls in the rank's block."""
    if not isinstance(dst, DTensor):
        dst[bidx, slot] = src
        return
    from repro_torch.distributed.sharding import local_shape_offset
    mesh, R = dst.device_mesh, Replicate()
    src_pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1
              else (p if p == Shard(0) else R) for p in dst.placements]
    slot_pl = [p if p == Shard(0) else R for p in dst.placements]
    c0 = local_shape_offset(
        dst.shape, mesh, dst.placements)[1][1]
    d = dst.to_local()
    s = _local(src, mesh, src_pl).to(d.dtype)
    loc = _local(slot, mesh, slot_pl) - c0
    ok = (loc >= 0) & (loc < d.shape[1])
    loc = loc.clamp(0, d.shape[1] - 1)
    rows = torch.arange(d.shape[0], device=d.device)
    ok = ok.view(-1, *([1] * (s.ndim - 1)))
    d[rows, loc] = torch.where(ok, s, d[rows, loc])


def _local(t, mesh, placements):
    """``t`` (a DTensor, or a plain tensor taken as replicated) placed as
    ``placements`` on ``mesh``: this rank's local tensor."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, placements).to_local()


def write_rows(dst, src, rows=None) -> None:
    """dst[rows] = src[rows] along the batch axis (all rows when None): the
    in-place state write of a decode step, limited to its active rows. A
    DTensor dst (all rows) takes src placed as it is, on each rank's
    shard."""
    if isinstance(dst, DTensor):
        if rows is not None:
            raise NotImplementedError("active rows of a DTensor state")
        dst.to_local().copy_(_local(src, dst.device_mesh, dst.placements))
        return
    if rows is None:
        dst.copy_(src)
    else:
        dst[rows] = src[rows]


# ----------------------------------------------------------------- embedding


def embed(cfg: ModelConfig, params, tokens):
    # F.embedding: the rows of plain indexing, bit for bit
    table = params["tok/embed"]
    if isinstance(table, DTensor):
        x = _embed_sharded(table, tokens)
    else:
        x = F.embedding(tokens.long(), table)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _embed_sharded(table, tokens):
    """The gather from a DTensor table: each rank gathers the tokens that
    fall in its block of the vocabulary (zeros for the rest), and the
    blocks meet in a sum; the batch stays split as the tokens are."""
    from repro_torch.distributed.sharding import local_shape_offset
    from torch.distributed.tensor.experimental import local_map
    mesh, R = table.device_mesh, Replicate()
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [R] * mesh.ndim,
                                    run_check=False)
    tp, ip, out, gp, vocab = [], [], [], [], []
    for i, (p, pt) in enumerate(zip(table.placements, tokens.placements)):
        if mesh.size(i) == 1:
            row = (p, pt, R, p)
        elif p == Shard(0):
            row = (p, R, R, p)
            vocab.append((mesh, i))
        else:
            # a table replicated over split tokens: each rank's gradient
            # is its rows' share
            bt = pt if pt in (Shard(0), Shard(1)) else R
            row = (R, bt, bt, Partial() if bt != R else R)
        for dst, pl in zip((tp, ip, out, gp), row):
            dst.append(pl)
    v0 = local_shape_offset(table.shape, mesh, tp)[1][0]

    def local(table, tokens):
        tok = tokens.long()
        if not vocab:
            return F.embedding(tok, table)
        lab = tok - v0
        mine = (lab >= 0) & (lab < table.shape[0])
        x = F.embedding(lab.clamp(0, table.shape[0] - 1), table)
        return all_reduce(x * mine[..., None].to(x.dtype), "sum", vocab)

    return local_map(local, out_placements=out, in_placements=(tp, ip),
                     in_grad_placements=(gp, ip), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def unembed(cfg: ModelConfig, params, x):
    """Logits over the padded vocab."""
    if cfg.tie_embeddings:
        return x @ params["tok/embed"].T
    return x @ params["tok/unembed"]


def lm_loss(cfg: ModelConfig, logits, labels, ignore: int = -1):
    """Mean cross-entropy over the padded vocab, float32; labels (B,S),
    entries equal to ``ignore`` left out; logits (B,S,V). On a DTensor
    split over the vocabulary each rank reduces its block and the blocks
    meet in a max and two sums (:func:`_lm_loss_sharded`)."""
    if isinstance(logits, DTensor):
        return _lm_loss_sharded(cfg, logits, labels, ignore)
    logits = logits.float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp_min(0).long()[..., None])[..., 0]
    ok = labels != ignore
    return torch.sum((lse - gold) * ok) / torch.clamp_min(torch.sum(ok), 1)


def _lm_loss_sharded(cfg: ModelConfig, logits, labels, ignore: int):
    from repro_torch.distributed.sharding import local_shape_offset
    from torch.distributed.tensor.experimental import local_map
    mesh, R = logits.device_mesh, Replicate()
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [R] * mesh.ndim,
                                    run_check=False)
    lp, bp, out, vocab = [], [], [], []
    for i, p in enumerate(logits.placements):
        if mesh.size(i) == 1:
            row = (p, labels.placements[i], R)
        elif p == Shard(2):
            row = (p, R, R)
            vocab.append((mesh, i))
        elif p in (Shard(0), Shard(1)):
            row = (p, p, Partial())
        else:
            row = (R, R, R)
        for dst, pl in zip((lp, bp, out), row):
            dst.append(pl)
    v0 = local_shape_offset(logits.shape, mesh, lp)[1][2]

    def local(logits, labels):
        ok = labels != ignore
        if not vocab:
            x = logits.float()
            if cfg.logit_softcap:
                x = cfg.logit_softcap * torch.tanh(x / cfg.logit_softcap)
            lse = torch.logsumexp(x, dim=-1)
            gold = torch.gather(x, -1, labels.clamp_min(0).long()[..., None])
            return torch.sum((lse - gold[..., 0]) * ok), torch.sum(ok)
        x = logits.float()
        if cfg.logit_softcap:
            x = cfg.logit_softcap * torch.tanh(x / cfg.logit_softcap)
        m = all_reduce(x.detach().amax(dim=-1, keepdim=True), "max", vocab)
        lse = m[..., 0] + torch.log(
            all_reduce(torch.exp(x - m).sum(dim=-1), "sum", vocab))
        lab = labels.clamp_min(0).long() - v0
        mine = (lab >= 0) & (lab < x.shape[-1])
        gold = torch.gather(x, -1, lab.clamp(0, x.shape[-1] - 1)[..., None])
        gold = all_reduce(gold[..., 0] * mine, "sum", vocab)
        return torch.sum((lse - gold) * ok), torch.sum(ok)

    nll, n = local_map(local, out_placements=(out, out),
                       in_placements=(lp, bp), device_mesh=mesh,
                       redistribute_inputs=True)(logits, labels)
    return nll / torch.clamp_min(n, 1)


# ------------------------------------------------------------ sharding hooks


def _redistribute(x, spec):
    from repro_torch.distributed.sharding import placements
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def _batch_entry(cfg: ModelConfig):
    ax = cfg.act_batch_axes
    return (tuple(ax) if len(ax) > 1 else ax[0]) if ax else None


def constrain_batch(cfg: ModelConfig, x):
    """Pin the leading (batch) dim of an activation to the configured mesh
    axes, replicated over the others (a no-op unless ``cfg.act_batch_axes``
    is set and ``x`` is a DTensor: the engine paths pay nothing)."""
    if not cfg.act_batch_axes or not isinstance(x, DTensor):
        return x
    return _redistribute(settled(x),
                         (_batch_entry(cfg),) + (None,) * (x.ndim - 1))


def constrain_seq_attention(cfg: ModelConfig, q, k, v):
    """Sequence-parallel attention (full-sequence prefill and train): q
    split on its sequence dim over ``cfg.attn_seq_axis``, K/V replicated
    along it (GQA K/V are small), so scores stay block-local. A no-op
    unless the axis is set and q is a DTensor."""
    if not cfg.attn_seq_axis or not isinstance(q, DTensor):
        return q, k, v
    b = _batch_entry(cfg)
    q = _redistribute(settled(q), (b, cfg.attn_seq_axis, None, None))
    k = _redistribute(settled(k), (b, None, None, None))
    v = _redistribute(settled(v), (b, None, None, None))
    return q, k, v
