"""Mesh definitions of the port.

``make_serve_mesh`` is the serving mesh (``repro/launch/mesh.py:36-64``):
``dp`` data shards x ``model`` tensor-parallel ranks, one device per
position. In this slice every position names the engine's one device
(the card by default, the CPU when asked): dp logical data shards on one
device, the counterpart of the reference's forced host devices. The
engine partitions its slots, page pool and state arena into the shards
and keeps the specs of the rule table (``distributed/sharding.py``);
placing them over several cards waits for the slice that brings
``torch.distributed`` (ROADMAP.md Queue 1 item 5).

Prefill/decode disaggregation (``ServeEngine(prefill_shards=k)``) is a
logical split of this mesh's data axis: prompt and chunk pages land on
the first k shards' page ranges, and decode slots on every shard read
them through the block table.

``make_local_mesh`` and ``make_production_mesh`` are meshes of shape
only, for the rule table and a later dry run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ServeMesh:
    """A mesh: ``shape`` (axis name to size), ``axis_names`` and, per
    position in row-major order, its device (None: a mesh of shape
    only)."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

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
