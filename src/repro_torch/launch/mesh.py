"""Mesh definitions of the port.

``make_serve_mesh`` is the serving mesh (``repro/launch/mesh.py:36-64``):
``dp`` data shards x ``model`` tensor-parallel ranks, one device per
position. It comes in two forms:

* ``make_rank_mesh(dp, model)``: one process a position, over the
  initialized ``torch.distributed`` group of dp * model ranks (under
  ``torchrun``: ``python -m torch.distributed.run --nproc-per-node N -m
  repro_torch.launch.serve --mesh dp,model``). Position ``(d, m)`` is
  rank ``d * model + m``, on ``cuda:LOCAL_RANK`` under NCCL; under gloo,
  on the card (every rank on the one card) or on the CPU when asked. The
  mesh carries the rank's ``distributed.context.RankWorld``; the model
  is cut for it (``build_model(..., world=)``) and the engine holds the
  rank's slot rows and pages.
* ``make_serve_mesh(dp)``: one process, every position on the engine's
  one device (the card by default, the CPU when asked): dp logical data
  shards on one device, the counterpart of the reference's forced host
  devices. The engine partitions its slots, page pool and state arena
  into the shards and keeps the specs of the rule table
  (``distributed/sharding.py``). A one-process mesh with ``model`` above
  1 or over several devices raises: it is served as ranks.

Prefill/decode disaggregation (``ServeEngine(prefill_shards=k)``) is a
logical split of this mesh's data axis: prompt and chunk pages land on
the first k shards' page ranges, and decode slots on every shard read
them through the block table.

``make_local_mesh`` and ``make_production_mesh`` are meshes of shape
only, for the rule table and a later dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed import context


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A mesh: ``shape`` (axis name to size), ``axis_names`` and, per
    position in row-major order, its device (None: a mesh of shape
    only); a rank mesh also its process's ``world``."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[torch.device, ...]] = None
    world: Optional[Any] = None

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


def _shape_mesh(shape, axes) -> ServeMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    return ServeMesh(dict(zip(axes, (int(n) for n in shape))), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> ServeMesh:
    """Single pod: (16, 16) = 256 positions, ("data", "model"); multi-pod:
    (2, 16, 16), ("pod", "data", "model"). Shape only."""
    if multi_pod:
        return _shape_mesh((2, 16, 16), ("pod", "data", "model"))
    return _shape_mesh((16, 16), ("data", "model"))


def make_local_mesh(shape=(2, 2), axes=("data", "model")) -> ServeMesh:
    """A small mesh of shape only."""
    return _shape_mesh(shape, axes)


def make_serve_mesh(dp: int = 0, *, model: int = 1,
                    device=None) -> ServeMesh:
    """Serving mesh of ``dp`` data shards x ``model`` ranks, every
    position on the one device ``device`` (default: the CUDA device;
    raises without a GPU unless ``device="cpu"``). ``dp=0`` takes
    ``torch.cuda.device_count() // model`` (one on the CPU)."""
    dev = resolve_device(device)
    if model < 1:
        raise ValueError(f"model={model}")
    if dp <= 0:
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        dp = max(1, n // model)
    return ServeMesh({"data": dp, "model": model}, ("data", "model"),
                     (dev,) * (dp * model))


def make_rank_mesh(dp: int, model: int = 1, *, device=None) -> ServeMesh:
    """The serving mesh of ``dp`` x ``model`` ranks, one process each,
    over the initialized default process group (``context.
    init_rank_world``; every rank calls this in the same order). Under
    NCCL each rank is on ``cuda:LOCAL_RANK``; under gloo on ``device``
    (the card by default, which raises without one; ``"cpu"`` for the
    CPU). Every position's device is listed as the rank's own where
    ranks share one (gloo), else as ``cuda:<rank>`` (one node)."""
    world = context.init_rank_world(dp, model, device=device)
    if world.backend == "nccl":
        devices = tuple(torch.device("cuda", r) for r in range(dp * model))
    else:
        devices = (world.device,) * (dp * model)
    return ServeMesh({"data": dp, "model": model}, ("data", "model"),
                     devices, world)
