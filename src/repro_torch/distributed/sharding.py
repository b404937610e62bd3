"""Logical-axis sharding rules with divisibility fallback, over shapes.

The port's copy of ``repro/distributed/sharding.py``'s rule table, as
plain functions of shapes: no tensor is placed here. One table maps
every parameter, cache, batch and serving-state leaf to a spec, a tuple
with one entry per dim: a mesh axis name, a tuple of names, or ``None``
(replicated). A dim is sharded on a mesh axis only if its size divides
by the axis size; otherwise it stays replicated (yi-34b's 56 query heads
do not divide by model=16, so that dim replicates). A mesh is any object
with ``.shape`` (axis name to size) and ``.axis_names``
(``launch.mesh.ServeMesh``, or a test's fake).

The rules read the port's trees:

* parameters: the flat state dict of ``Model`` (``convert.params_from_
  jax``'s names, ``layers.<i>.attn.wq.kernel``), layers unstacked, so the
  reference's stacked leading axis is gone and every spec covers the
  leaf's own dims;
* caches: the port's flat cache dicts (``models/transformer.py``,
  ``models/encdec.py``), each leaf but ``pos`` and ``block_table``
  stacked over its kind's layers on axis 0 and batched on axis 1; the
  paged pools ``(num_layers, P, ps, Hkv, hd)`` shard on the page axis.

Axis roles:
  "model"          tensor parallelism: MLP hidden, attention heads,
                   per-expert FFN width, vocab
  "data" (+"pod")  batch/data parallelism; also FSDP parameter sharding,
                   MoE expert parallelism, and the page axis of the
                   serving pools
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import RGLRU, SSM, ModelConfig, ShapeConfig

Spec = Tuple[Any, ...]

# parameters whose contracting dim is model-sharded (Megatron row-parallel)
ROW_PARALLEL = {"wo", "w_down", "out_proj"}
# parameters that stay replicated whatever their shape
ALWAYS_REPLICATED = {"router", "lam", "A_log", "D", "dt_bias", "norm",
                     "scale", "bias", "conv_b", "q_norm", "k_norm",
                     "pos_emb"}
# cache leaves of the port stacked over layers on axis 0
_UNSTACKED_CACHE = ("pos", "block_table")
# the port's names of the reference's "conv" cache leaf
_CONV_LEAVES = ("ssm_conv", "rglru_conv")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    model_axis: str = "model"
    fsdp: bool = True           # shard params' non-model dim over data axes
    expert_axis: str = "data"   # MoE expert-parallel axis


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor or array's ``.shape``, or the shape
    itself."""
    return tuple(int(n) for n in getattr(leaf, "shape", leaf))


def replicated(ndim: int) -> Spec:
    return (None,) * ndim


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ("pod", "data") on the multi-pod mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _maybe(mesh, dim_size: int, axes) -> Optional[Any]:
    """``axes`` if the mesh has them all and ``dim_size`` divides by their
    product, else None (replicate). A missing axis is on purpose: a
    serving mesh may carry only a "data" axis."""
    if axes is not None:
        named = (axes,) if isinstance(axes, str) else axes
        if any(a not in mesh.axis_names for a in named):
            return None
    return axes if dim_size % _axsize(mesh, axes) == 0 else None


def _norm(ax):
    """A one-name tuple of axes is that name."""
    if isinstance(ax, tuple) and len(ax) == 1:
        return ax[0]
    return ax


def _names(key: str):
    """A state-dict key's path names, sequence indices dropped
    (``layers.3.attn.wq.kernel`` -> layers, attn, wq, kernel)."""
    return [n for n in key.split(".") if not n.isdigit()]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_spec(mesh, rules: ShardingRules, key: str, shape) -> Spec:
    """``sharding.py:93-157`` on an unstacked leaf."""
    names = _names(key)
    # the parameter's name, not the "kernel" leaf of a dense layer
    name = names[-1] if names[-1] != "kernel" or len(names) < 2 \
        else names[-2]
    dp = dp_axes(mesh)
    model = rules.model_axis
    nd = len(shape)
    if nd <= 1 or name in ALWAYS_REPLICATED or \
            set(names) & ALWAYS_REPLICATED:
        return replicated(nd)

    def build(dims):
        return tuple(_norm(d) for d in dims)

    # MoE expert weights: (E, d, f) / (E, f, d)
    if name in ("w_gate", "w_up", "w_down") and nd == 3:
        e_ax = _maybe(mesh, shape[0], dp if len(dp) > 1 else rules.expert_axis)
        if name == "w_down":   # (E, f, d): f is the contracting model dim
            return build([e_ax, _maybe(mesh, shape[1], model), None])
        return build([e_ax, None, _maybe(mesh, shape[2], model)])
    # embedding (V, d) / unembedding (d, V): vocab over "model" only (an
    # FSDP-sharded d would gather the global batch of logits)
    if name == "table":
        return build([_maybe(mesh, shape[0], model), None])
    if "unembed" in names:
        return build([None, _maybe(mesh, shape[1], model)])
    # conv weights (W, ch): channels over model
    if name == "conv_w":
        return build([None, _maybe(mesh, shape[1], model)])
    if nd == 2:
        if name in ROW_PARALLEL:
            # (contract=model dim, out=d_model): d stays replicated, since
            # FSDP on the output dim gathers the residual stream
            return build([_maybe(mesh, shape[0], model), None])
        m_ax = _maybe(mesh, shape[1], model)
        d_ax = _maybe(mesh, shape[0], dp) if rules.fsdp else None
        return build([d_ax, m_ax])
    return replicated(nd)


def param_specs(cfg: ModelConfig, params: Mapping[str, Any], mesh,
                rules: ShardingRules = ShardingRules()) -> Dict[str, Spec]:
    """Spec of every parameter of a flat state dict (tensors or shapes)."""
    return {k: _param_spec(mesh, rules, k, _shape(v))
            for k, v in params.items()}


def opt_state_specs(cfg: ModelConfig, opt, mesh,
                    rules: ShardingRules = ShardingRules()):
    """An ``OptState``'s specs: m and v mirror the parameters, the step
    is replicated."""
    return type(opt)(step=replicated(len(_shape(opt.step))),
                     m=param_specs(cfg, opt.m, mesh, rules),
                     v=param_specs(cfg, opt.v, mesh, rules))


# ---------------------------------------------------------------------------
# Cache / batch
# ---------------------------------------------------------------------------

def _cache_spec(mesh, rules: ShardingRules, name: str, shape) -> Spec:
    """``sharding.py:180-236`` on a port cache leaf."""
    dp = dp_axes(mesh)
    model = rules.model_axis
    off = 0 if name in _UNSTACKED_CACHE else 1
    eff = shape[off:]

    def build(dims):
        return tuple([None] * off + [_norm(d) for d in dims])

    if name in ("k_pages", "v_pages", "k_scale", "v_scale"):
        # the serving pool shards on its page axis over the data shards,
        # whose boundaries are the allocator's per-shard page-id ranges;
        # quantized pools' scales shard with their values
        dims = [None] * len(shape)
        dims[1] = _norm(_maybe(mesh, shape[1], dp))
        return tuple(dims)
    if name == "block_table":
        return (_norm(_maybe(mesh, shape[0], dp)), None)
    if name == "pos":
        return (_norm(_maybe(mesh, shape[0], dp)),)
    if name in ("k", "v", "cross_k", "cross_v"):
        # (B, S, Hkv, hd): heads over model, else the sequence (context
        # parallelism) when Hkv does not divide
        b_ax = _maybe(mesh, eff[0], dp)
        h_ax = _maybe(mesh, eff[2], model)
        if h_ax is not None:
            return build([b_ax, None, h_ax, None])
        return build([b_ax, _maybe(mesh, eff[1], model), None, None])
    if name == "ssd":        # (B, H, P, N)
        return build([_maybe(mesh, eff[0], dp), _maybe(mesh, eff[1], model),
                      None, None])
    if name in _CONV_LEAVES:  # (B, W-1, ch)
        return build([_maybe(mesh, eff[0], dp), None,
                      _maybe(mesh, eff[2], model)])
    if name == "h":          # (B, w)
        return build([_maybe(mesh, eff[0], dp), _maybe(mesh, eff[1], model)])
    return replicated(len(shape))


def cache_specs(cfg: ModelConfig, cache: Mapping[str, Any], mesh,
                rules: ShardingRules = ShardingRules()) -> Dict[str, Spec]:
    """Spec of every leaf of a port cache dict (dense, paged, recurrent or
    encoder-decoder; tensors or shapes)."""
    return {k: _cache_spec(mesh, rules, k, _shape(v))
            for k, v in cache.items()}


def batch_specs(shape_cfg: ShapeConfig, batch: Mapping[str, Any],
                mesh) -> Dict[str, Spec]:
    """Input batches: tokens, labels, evidence and decode tokens shard
    their batch dim over the data axes when it divides."""
    dp = dp_axes(mesh)
    out = {}
    for name, leaf in batch.items():
        shape = _shape(leaf)
        if name in ("tokens", "labels", "evidence", "token"):
            b_ax = dp if shape[0] % _axsize(mesh, dp) == 0 else None
            out[name] = (_norm(b_ax),) + (None,) * (len(shape) - 1)
        else:
            out[name] = replicated(len(shape))
    return out


# ---------------------------------------------------------------------------
# Serving (data-parallel decode batch, page-axis-sharded KV pools)
# ---------------------------------------------------------------------------

def batch_leading_spec(mesh, shape) -> Spec:
    """A serving-state leaf sharded on its leading (decode-batch) dim over
    the data axes, the rest replicated."""
    shape = _shape(shape)
    if not shape:
        return ()
    return (_norm(_maybe(mesh, shape[0], dp_axes(mesh))),) + \
        (None,) * (len(shape) - 1)


def engine_state_specs(cfg: ModelConfig, state, mesh,
                       rules: ShardingRules = ShardingRules()
                       ) -> Dict[str, Any]:
    """Specs of a ``ServeEngine``'s ``EngineState`` (a dataclass whose
    ``cache`` field is the cache dict): ``{"cache": {leaf: spec}, field:
    spec}``. Every per-slot leaf shards its leading dim over the data
    axes; paged pools shard their page axis with the same shard count, so
    a slot's block-table lookups resolve to its own shard's pages."""
    out: Dict[str, Any] = {"cache": cache_specs(cfg, state.cache, mesh,
                                                rules)}
    for f in dataclasses.fields(state):
        if f.name != "cache":
            out[f.name] = batch_leading_spec(mesh, getattr(state, f.name))
    return out


def prefill_shard_ids(dp: int, prefill_shards: int) -> Tuple[int, ...]:
    """Data shards that host prompt and chunk pages under prefill/decode
    disaggregation: the first ``prefill_shards`` (0: no disaggregation,
    every shard hosts its own slots' prompt pages). Tail and frontier
    pages always stay on the slot's own shard."""
    if not 0 <= prefill_shards <= dp:
        raise ValueError(f"prefill_shards {prefill_shards} must be in "
                         f"[0, dp={dp}]")
    return tuple(range(prefill_shards or dp))


def serve_param_specs(cfg: ModelConfig, params: Mapping[str, Any], mesh,
                      rules: ShardingRules = ShardingRules()
                      ) -> Dict[str, Spec]:
    """Parameter placement for serving: replicated when the mesh has no
    real model axis, else the training tensor-parallel rules without
    FSDP (decode batches are small; a gather a step would dominate)."""
    if rules.model_axis not in mesh.axis_names or \
            mesh.shape[rules.model_axis] <= 1:
        return {k: replicated(len(_shape(v))) for k, v in params.items()}
    return param_specs(cfg, params, mesh,
                       dataclasses.replace(rules, fsdp=False))


# ---------------------------------------------------------------------------
# Placement over ranks (the counterpart of ``to_shardings``, ``:260``)
# ---------------------------------------------------------------------------

def _block(mesh, axes, coords: Mapping[str, int]) -> Tuple[int, int]:
    """(index, count) of a position's block along a dim sharded on
    ``axes``: row-major over the axes, as a mesh lays them out."""
    named = (axes,) if isinstance(axes, str) else tuple(axes)
    idx, n = 0, 1
    for a in named:
        idx = idx * mesh.shape[a] + int(coords[a])
        n *= mesh.shape[a]
    return idx, n


@dataclasses.dataclass(frozen=True)
class Parts:
    """A spec entry of a dim laid out as consecutive parts of ``sizes``:
    the parts whose ``cut`` is true are each cut into equal blocks over
    ``axes`` (a position keeps its block of each), the others are held
    whole by every position. The SSD block's ``in_proj`` columns ``(z |
    x | B | C | dt)`` are one: the heads' parts cut, the one group's B
    and C whole."""
    axes: Any
    sizes: Tuple[int, ...]
    cut: Tuple[bool, ...]


def _narrow(tensor, dim: int, start: int, size: int, n: int, what):
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                         f"divide over {what} ({n} blocks)")
    return tensor.narrow(dim, start, size // n)


def local_shard(tensor, spec: Spec, mesh, coords: Mapping[str, int]):
    """A position's block of a whole tensor under ``spec``: every dim
    sharded on axes is cut into their product of equal blocks and the
    block at ``coords`` (axis name to index) is kept; a ``Parts`` dim
    keeps its block of each cut part and every whole part, in order. A
    view where the cut allows one."""
    out = tensor
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        if isinstance(axes, Parts):
            idx, n = _block(mesh, axes.axes, coords)
            pieces, start = [], 0
            for size, cut in zip(axes.sizes, axes.cut):
                pieces.append(
                    _narrow(out, dim, start + idx * (size // n), size, n,
                            axes.axes) if cut else out.narrow(dim, start,
                                                              size))
                start += size
            out = pieces[0] if len(pieces) == 1 else \
                torch.cat(pieces, dim=dim)
            continue
        idx, n = _block(mesh, axes, coords)
        size = out.shape[dim]
        out = _narrow(out, dim, idx * (size // n), size, n, axes)
    return out


def place(tensors: Mapping[str, Any], specs: Mapping[str, Spec], mesh,
          coords: Mapping[str, int]) -> Dict[str, Any]:
    """``local_shard`` over a flat dict (a state dict, a cache): each
    position's blocks, as contiguous tensors."""
    return {k: local_shard(v, specs[k], mesh, coords).contiguous()
            for k, v in tensors.items()}


def cut_specs(specs: Mapping[str, Spec]) -> Dict[str, Spec]:
    """The specs a rank cuts its parameters by: the serving specs, but a
    projection's bias goes with its kernel's output columns. The table
    replicates biases (GSPMD slices them to the sharded activation); a
    rank adds its columns' bias."""
    out = dict(specs)
    for name in specs:
        kernel = name[:-len("bias")] + "kernel"
        if name.endswith(".bias") and kernel in specs:
            out[name] = tuple(specs[kernel][1:])
    return out


def _model_size(mesh, rules: ShardingRules) -> int:
    if rules.model_axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[rules.model_axis])


def _ssm_dims(cfg: ModelConfig):
    """(inner, heads, N) of the config's SSD block."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    return inner, inner // s.head_dim, s.state_dim


def rank_specs(cfg: ModelConfig, params: Mapping[str, Any], mesh,
               rules: ShardingRules = ShardingRules()) -> Dict[str, Spec]:
    """The specs a rank cuts its parameters by (``Model._keeper``,
    ``convert.rank_params``): ``cut_specs`` of the serving specs, but
    where the rule table would cut a decoder layer mid-part or leave a
    per-channel vector whole beside its cut channels, on a model axis
    above 1:

    * an SSD block's ``in_proj`` columns ``(z | x | B | C | dt)`` are cut
      by part (``Parts``): z, x and dt take the rank's heads, the one
      group's B and C stay whole on every model rank (the table cuts the
      flat columns, 6448 into halves of 3224 at mamba2's width, across
      the parts); its ``conv_w``/``conv_b`` channels likewise (x cut, B
      and C whole), and ``A_log``, ``D``, ``dt_bias`` and the gated
      norm's ``norm`` take the rank's heads or channels (the table
      replicates them); ``out_proj`` stays row-parallel;
    * an RG-LRU block's ``conv_b`` and ``lam`` take the rank's block of
      the width (replicated in the table); its ``w_x``, ``w_gate``,
      ``conv_w``, the columns of ``w_a`` and ``w_i`` and the rows of
      ``out_proj`` are the table's cuts;
    * a non-gated (gelu, relu) LM MLP's ``w_out`` is row-parallel, its
      rows with ``w_in``'s columns, so that a layer sums once over the
      model group as the gated MLP does; the table cuts ``w_out``'s
      output dim (divergence D5, placement only);
    * attention with fewer kv heads than the model axis (one kv head:
      ``check_model_split``) keeps ``wk``/``wv`` whole on every model
      rank beside its ``H / model`` query heads; the table cuts their
      columns mid-head and the cache's sequence (divergence D6).

    The vision tower's and the MoE's parameters keep ``cut_specs``."""
    specs = cut_specs(serve_param_specs(cfg, params, mesh, rules))
    m = _model_size(mesh, rules)
    if m <= 1:
        return specs
    model = rules.model_axis
    kv_whole = 0 < cfg.num_kv_heads < m
    for key in specs:
        names = key.split(".")
        if names[0] != "layers" or len(names) < 4:
            continue
        block, leaf = names[2], ".".join(names[3:])
        nd = len(_shape(params[key]))
        if block == "ssm":
            inner, heads, N = _ssm_dims(cfg)
            conv = Parts(model, (inner, N, N), (True, False, False))
            if leaf == "in_proj.kernel":
                specs[key] = (None, Parts(model, (inner, inner, N, N, heads),
                                          (True, True, False, False, True)))
            elif leaf == "conv_w":
                specs[key] = (None, conv)
            elif leaf == "conv_b":
                specs[key] = (conv,)
            elif leaf in ("A_log", "D", "dt_bias", "norm"):
                specs[key] = (model,)
        elif block == "rglru" and leaf in ("conv_b", "lam"):
            specs[key] = (model,)
        elif block == "mlp" and leaf == "w_out.kernel":
            specs[key] = (_maybe(mesh, _shape(params[key])[0], model), None)
        elif block == "attn" and kv_whole and \
                leaf.split(".")[0] in ("wk", "wv"):
            specs[key] = replicated(nd)
    return specs


def rank_coords(world) -> Dict[str, int]:
    """A rank world's position by axis name (the ``coords`` of
    ``local_shard``)."""
    return dict(zip(world.axis_names, world.coords))


def check_model_split(cfg: ModelConfig, mesh,
                      rules: ShardingRules = ShardingRules()) -> None:
    """Refuse a model axis the port cannot run. The split must cut whole
    heads and keep each query head with its kv head: H must divide, and
    Hkv divide or be one kv head, which every model rank then holds
    whole beside its ``H / model`` query heads (``rank_specs``; the
    reference's rule cuts the flat ``H * hd`` dims, which GSPMD may
    split mid-head: granite-34b's and recurrentgemma-2b's one kv head
    under model=2). A vision tower's heads must split whole too. An SSD
    block's heads and an RG-LRU block's width must divide, as
    ``rank_specs`` cuts them in equal blocks. MoE experts run as the rule
    table cuts them at model > 1: on the data axis where E divides dp
    (else each data rank holds them all) and their hidden width ``f`` on
    the model axis, which must divide: the port does not hold every
    expert whole on every model rank, as the table's fallback would. A
    gated MLP is the table's column and row cuts, a non-gated one
    ``rank_specs``' (``w_out`` row-parallel)."""
    m = mesh.shape.get(rules.model_axis, 1)
    if m <= 1:
        return
    where = "(ROADMAP.md Queue 1 item 5)"
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    if H % m or (Hkv % m and Hkv != 1):
        raise NotImplementedError(
            f"{cfg.name}: {H} query heads over {Hkv} kv heads do not split "
            f"whole over model={m}; the port splits whole query heads, each "
            f"with its kv head or beside the one kv head {where}")
    v = cfg.vision
    if v is not None and v.num_heads % m:
        raise NotImplementedError(
            f"{cfg.name}: the vision tower's {v.num_heads} heads do not "
            f"split whole over model={m}; the port splits whole heads only "
            f"{where}")
    if cfg.moe is not None and cfg.moe.expert_d_ff % m:
        raise NotImplementedError(
            f"{cfg.name}: the experts' hidden width {cfg.moe.expert_d_ff} "
            f"does not split over model={m}; the port cuts it in equal "
            f"blocks only {where}")
    kinds = set(cfg.layer_kinds)
    if SSM in kinds and _ssm_dims(cfg)[1] % m:
        raise NotImplementedError(
            f"{cfg.name}: {_ssm_dims(cfg)[1]} SSD heads do not split whole "
            f"over model={m} {where}")
    width = (cfg.rglru.lru_width or cfg.d_model) if cfg.rglru else 0
    if RGLRU in kinds and width % m:
        raise NotImplementedError(
            f"{cfg.name}: the RG-LRU width {width} does not split over "
            f"model={m}; the port cuts it in equal blocks only {where}")
