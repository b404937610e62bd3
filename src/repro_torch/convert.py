"""Carry the JAX package's parameters into the port.

``params_from_jax`` takes the reference's param pytree with numpy leaves
(``jax.tree.map(np.asarray, params)``) and returns a state dict for
``models.model.Model``. The reference stacks the layers of each
block-pattern position on a leading axis (``params["super"]``,
``repro/models/transformer.py:153-155``); layer ``i * len(pattern) + p``
is entry ``i`` of ``params["super"][p]``, and the unstacked
``params["tail"]`` layers follow; an MoE layer's leaves land at
``layers.<i>.moe.router.kernel`` and ``layers.<i>.moe.w_gate`` (up,
down), an SSD layer's at ``layers.<i>.ssm.*`` and an RG-LRU layer's at
``layers.<i>.rglru.*``, as they are. Leaves keep the tree's dtypes: the
SSD block's ``A_log``, ``D``, ``dt_bias`` and the RG-LRU's ``lam`` stay
fp32 in a bf16 tree, as the port's modules hold them (``load_state_dict``
keeps each parameter's dtype). Other subtrees flatten by name; a
sequence inside them, such as the vision tower's tuple of blocks
(``repro/models/vision.py:62``), by index: ``vision.blocks.<i>.wq.kernel``.
The evidence projection carries over as ``evidence_proj.kernel``. An
encoder-decoder's tree (``repro/models/encdec.py:46-63``) stacks its
encoder layers in ``enc_super`` and its decoder layers, cross-attention
``xattn`` and ``lnx`` included, in ``dec_super``: entry ``i`` lands at
``enc_layers.<i>.*`` and ``dec_layers.<i>.*``, and ``enc_norm`` as it is.
``opt_state_from_jax`` carries an optimizer state's moments the same way.
``rank_params`` is ``params_from_jax`` cut to a rank's blocks
(``sharding.place`` under ``sharding.rank_specs``), the state dict of a model
built for that rank (``build_model(..., world=)``).
``flat_from_jax`` is the same walk without the tensor conversion: any
tree of array-likes with a ``shape`` (broadcast views, object arrays of
per-layer values) comes back flat, under the state dict's names.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.distributed import sharding as shd


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            _flatten(v, name + ".", out)
        elif isinstance(v, Sequence):
            _flatten({str(i): x for i, x in enumerate(v)}, name + ".", out)
        else:
            out[name] = np.asarray(v)


def params_from_jax(np_tree: Mapping[str, Any],
                    cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """State dict (CPU tensors, the tree's dtypes) for ``Model(cfg)``."""
    return {k: _to_tensor(v) for k, v in flat_from_jax(np_tree, cfg).items()}


def rank_params(np_tree: Mapping[str, Any], cfg: ModelConfig,
                world) -> Dict[str, torch.Tensor]:
    """The rank's blocks of ``params_from_jax``: each parameter cut by
    the serving specs of the world's mesh as the port cuts them
    (``sharding.rank_specs``, which ``Model._keeper`` reads too), MoE
    experts on dim 0 over the data axis and their ``f`` over the model
    axis where the specs cut them, an SSD block's ``in_proj`` by part."""
    full = params_from_jax(np_tree, cfg)
    specs = shd.rank_specs(cfg, full, world)
    return shd.place(full, specs, world, shd.rank_coords(world))


def flat_from_jax(np_tree: Mapping[str, Any],
                  cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The reference tree's leaves (numpy, layers unstacked) under the
    names of ``Model(cfg)``'s state dict."""
    if cfg.is_encoder_decoder:
        flat: Dict[str, np.ndarray] = {}
        stacks = {"enc_super": ("enc_layers", cfg.num_encoder_layers),
                  "dec_super": ("dec_layers", cfg.num_layers)}
        _flatten({k: v for k, v in np_tree.items() if k not in stacks},
                 "", flat)
        for key, (prefix, n) in stacks.items():
            _unstack(np_tree[key], n, lambda i: f"{prefix}.{i}.", key, flat)
        return flat
    pat = cfg.block_pattern
    n_super = cfg.num_layers // len(pat)
    flat: Dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in np_tree.items() if k not in ("super", "tail")},
             "", flat)
    for p, stacked in enumerate(np_tree["super"]):
        _unstack(stacked, n_super,
                 lambda i, p=p: f"layers.{i * len(pat) + p}.", f"super[{p}]",
                 flat)
    for j, layer in enumerate(np_tree.get("tail", ())):
        per_layer: Dict[str, np.ndarray] = {}
        _flatten(layer, "", per_layer)
        for name, arr in per_layer.items():
            flat[f"layers.{n_super * len(pat) + j}.{name}"] = arr
    return flat


def _unstack(stacked, n: int, prefix, what: str,
             out: Dict[str, np.ndarray]) -> None:
    """Entry ``i`` of every leaf of a tree stacked on a leading axis of
    ``n`` layers, under ``prefix(i)``."""
    leaves: Dict[str, np.ndarray] = {}
    _flatten(stacked, "", leaves)
    for name, arr in leaves.items():
        if arr.shape[0] != n:
            raise ValueError(f"{what}.{name}: leading axis {arr.shape[0]} "
                             f"!= {n} layers")
        for i in range(n):
            out[f"{prefix(i)}{name}"] = arr[i]


def opt_state_from_jax(opt_np, cfg: ModelConfig):
    """The reference's ``OptState`` with numpy leaves (``jax.tree.map(
    np.asarray, opt)``) as the port's: the step counter, and ``m``, ``v``
    keyed as ``params_from_jax`` keys the parameters (CPU tensors, the
    moments' dtypes)."""
    from repro_torch.training.optimizer import OptState
    return OptState(step=torch.tensor(int(np.asarray(opt_np.step)),
                                      dtype=torch.int32),
                    m=params_from_jax(opt_np.m, cfg),
                    v=params_from_jax(opt_np.v, cfg))


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":       # ml_dtypes bfloat16: go via bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))      # a writable copy
