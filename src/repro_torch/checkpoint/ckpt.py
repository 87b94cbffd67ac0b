"""Msgpack checkpoints of tensor trees (params + optimizer state), in the
JAX package's layout, so either package reads the other's files.

A tree (nested dicts, lists, tuples and NamedTuples of tensors; the
port's flat ``a/b/c``-keyed params dict is a dict like any other) is
flattened to ``{path: {"dtype", "shape", "data"}}`` with ``a/b/c`` paths,
``data`` the leaf's raw bytes in C order and ``dtype`` its numpy name:
bf16 leaves are stored as their raw bits under the name ``"bfloat16"``,
as ml_dtypes names them.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import msgpack
import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):                      # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = torch.as_tensor(tree)
    return out


def _record(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape), "data": bits.numpy().tobytes()}


def _tensor(rec: dict) -> torch.Tensor:
    name = rec["dtype"]
    if name == "bfloat16":
        dtype = torch.bfloat16
    else:
        dtype = torch.from_numpy(np.zeros(0, name)).dtype
    if not rec["data"]:
        return torch.zeros(rec["shape"], dtype=dtype)
    return torch.frombuffer(bytearray(rec["data"]),
                            dtype=dtype).reshape(rec["shape"])


def save_checkpoint(path: str, tree: Any) -> None:
    payload = {k: _record(v) for k, v in _flatten(tree).items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload))
    os.replace(tmp, path)


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Every entry of a checkpoint file as ``{path: tensor}`` on the CPU."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), strict_map_key=False)
    return {k: _tensor(rec) for k, rec in payload.items()}


def load_checkpoint(path: str, like: Any) -> Any:
    """The tree ``like`` with every leaf read from ``path``; each tensor
    lands on the device of the leaf of ``like`` it replaces."""
    flat = read_checkpoint(path)

    def restore(key_prefix, node):
        if isinstance(node, dict):
            return {k: restore(f"{key_prefix}{k}/", v)
                    for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(**{k: restore(f"{key_prefix}{k}/",
                                            getattr(node, k))
                                 for k in node._fields})
        if isinstance(node, (list, tuple)):
            return type(node)(restore(f"{key_prefix}{i}/", v)
                              for i, v in enumerate(node))
        t = flat[key_prefix[:-1]]
        return t.to(node.device) if isinstance(node, torch.Tensor) else t

    return restore("", like)
