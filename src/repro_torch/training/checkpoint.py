"""Checkpoints in the reference's layout (``repro/training/checkpoint.py``):
``path.npz`` holds the leaves as ``leaf_<i>``, ``path.json`` their
``kinds`` (dtype names), the ``step`` and ``n_leaves``. bfloat16 goes
through a uint16 view (npz has no bf16).

A tree is a model's ``state_dict()``, an ``OptState`` or any nesting of
dicts, lists, tuples and named tuples with tensor (or numpy, or number)
leaves, flattened depth first in its own order.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            _leaves(v, f"{prefix}{k}.", out)
    else:
        out.append((prefix[:-1], tree))


def _rebuild(like, leaves):
    if isinstance(like, dict):
        return type(like)((k, _rebuild(v, leaves)) for k, v in like.items())
    if isinstance(like, (list, tuple)):
        items = [_rebuild(v, leaves) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") \
            else type(like)(items)
    return next(leaves)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree, step: int = 0) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves: List[Tuple[str, Any]] = []
    _leaves(tree, "", leaves)
    payload, kinds = {}, []
    for i, (_, leaf) in enumerate(leaves):
        payload[f"leaf_{i}"], kind = _to_numpy(leaf)
        kinds.append(kind)
    np.savez(path + ".npz", **payload)
    spec = {"kinds": kinds, "step": step, "n_leaves": len(kinds)}
    with open(path + ".json", "w") as f:
        json.dump(spec, f)


def load_checkpoint(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shapes must match): each
    tensor leaf comes back on its ``like`` leaf's device. Returns (tree,
    step)."""
    with open(path + ".json") as f:
        spec = json.load(f)
    data = np.load(path + ".npz")
    leaves: List[Tuple[str, Any]] = []
    _leaves(like, "", leaves)
    if len(leaves) != spec["n_leaves"]:
        raise ValueError(f"checkpoint {path}: {spec['n_leaves']} leaves, "
                         f"the tree has {len(leaves)}")
    out = []
    for i, ((name, leaf), kind) in enumerate(zip(leaves, spec["kinds"])):
        arr = data[f"leaf_{i}"]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(f"checkpoint {path}: leaf {i} ({name}) has "
                             f"shape {arr.shape}, the tree {np.shape(leaf)}")
        if kind == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        out.append(t.to(leaf.device) if torch.is_tensor(leaf) else arr)
    return _rebuild(like, iter(out)), spec["step"]
