"""The rank world of a serving mesh, and the model's sharding context.

The port's counterpart of ``repro/distributed/context.py``. The
reference leaves placement to GSPMD: model code at most pins a sharding
(``maybe_constrain``, ``constrain_logits``) and XLA inserts the
collectives. The port places every tensor itself
(``distributed.sharding.place``) and runs the collectives itself, over
``torch.distributed`` process groups held in a ``RankWorld``:

* rank ``r`` of a ``(dp, model)`` mesh sits at position ``(d, m) =
  divmod(r, model)``;
* its model group is the ranks ``(d, 0..model-1)``: the row-parallel
  reductions (``wo``, ``w_down``), the vocab-parallel embedding's sum
  and the gather of vocab-sharded logits run over it;
* its data group is the ranks ``(0..dp-1, m)``: the serving engine's
  exit flags and its per-slot outputs run over it, and so do an MoE
  layer's gather of the decode rows, its sum over the experts split on
  the data axis and the expert-parallel all-to-alls
  (``models/moe.py``, ``models/moe_shard_map.py``);
* the world (the default group) carries the cross-modal scores rank 0
  hands every rank (``broadcast``) and an MoE layer's sum over both
  axes (``all_reduce_world``); a recurrent engine's arena row goes from
  its shard's data rank to the others over the data group
  (``broadcast_data``).

A collective over a gloo group on CUDA tensors stages through the host
here, by name (``_host``): gloo computes on host memory. Without a world
every collective is the identity, and a model or engine built without
one runs as on one device. ``set_expert_axes`` and ``set_batch_axes``
keep the reference's names for launchers; ``maybe_constrain`` is the
identity, since nothing here is placed by a constraint.
"""
from __future__ import annotations

import dataclasses
import os
from contextvars import ContextVar
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(eq=False)
class RankWorld:
    """This process's place in a ``(dp, model)`` mesh of ranks, its
    device and the process groups of its data and model axes."""
    dp: int
    model: int
    rank: int
    backend: str
    device: torch.device
    data_group: Any
    model_group: Any

    @property
    def size(self) -> int:
        return self.dp * self.model

    @property
    def coords(self) -> Tuple[int, int]:
        """(d, m): the rank's data shard and model shard."""
        return divmod(self.rank, self.model)

    # the world is a mesh of shape for the rule table
    # (``distributed/sharding.py``), its axes in coordinate order
    axis_names = ("data", "model")

    @property
    def shape(self):
        return {"data": self.dp, "model": self.model}

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective runs on: a host copy of a CUDA tensor
        on a gloo group, else the tensor itself."""
        if self.backend == "gloo" and t.device.type == "cuda":
            return t.to("cpu")
        return t.contiguous()

    def _all_reduce(self, t, group, op=dist.ReduceOp.SUM):
        x = self._host(t)
        dist.all_reduce(x, op=op, group=group)
        if x is not t:
            t.copy_(x)
        return t

    def _all_gather(self, t, group, n: int, dim: int):
        x = self._host(t)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim).to(t.device)

    def all_reduce_world(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over every rank, in place; returns ``t``."""
        return self._all_reduce(t, None)

    def all_reduce_data(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data group, in place; returns ``t``."""
        return self._all_reduce(t, self.data_group)

    def all_reduce_model(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model group, in place; returns ``t``."""
        return self._all_reduce(t, self.model_group)

    def all_gather_model(self, t: torch.Tensor, dim: int = -1):
        """The model group's blocks of ``t``, concatenated on ``dim`` in
        model-coordinate order."""
        return self._all_gather(t, self.model_group, self.model, dim)

    def all_gather_data(self, t: torch.Tensor, dim: int = 0):
        """The data group's blocks of ``t``, concatenated on ``dim`` in
        data-coordinate order."""
        return self._all_gather(t, self.data_group, self.dp, dim)

    def reduce_scatter_data(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data group, cut into ``dp`` equal
        blocks on dim 0 in data-coordinate order: this rank's block."""
        x = self._host(t)
        out = x.new_empty((x.shape[0] // self.dp,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=self.data_group)
        return out.to(t.device)

    def all_to_all_data(self, t: torch.Tensor) -> torch.Tensor:
        """Block j of ``t``'s ``dp`` equal blocks on dim 0 goes to data
        rank j; returns the blocks received, block j from data rank j."""
        x = self._host(t)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.data_group)
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank of the world, in place;
        returns ``t``."""
        x = self._host(t)
        dist.broadcast(x, src=src)
        if x is not t:
            t.copy_(x)
        return t

    def broadcast_data(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Data rank ``src``'s ``t`` on every rank of the data group, in
        place; returns ``t``."""
        x = self._host(t)
        dist.broadcast(x, src=src * self.model + self.coords[1],
                       group=self.data_group)
        if x is not t:
            t.copy_(x)
        return t

    def any_data(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max of an int32 tensor over the data group, in
        place (a flag set on any data shard)."""
        return self._all_reduce(t, self.data_group, dist.ReduceOp.MAX)

    def warm(self) -> None:
        """One eager collective on each group, so that a communicator made
        lazily (NCCL's) exists before a CUDA graph captures collectives."""
        for group in (self.data_group, self.model_group):
            self._all_reduce(torch.zeros(1, device=self.device), group)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _device_for(backend: str, device) -> torch.device:
    """A rank's device: ``cuda:LOCAL_RANK`` under NCCL; under gloo the
    device asked for (the card by default, or the CPU)."""
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {device}; "
                             "name the gloo backend for the CPU")
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; name the gloo "
                               "backend and device='cpu' for the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
        return dev
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to serve gloo ranks on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_rank_world(dp: int, model: int = 1, *, device=None) -> RankWorld:
    """The ``(dp, model)`` world over the default process group, which
    must be initialized with dp * model ranks. Every rank calls this, in
    the same order as its other group creations: each makes every data
    and model group. Becomes the current world (``get_world``)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: run under torchrun "
                           "(python -m torch.distributed.run) or call "
                           "torch.distributed.init_process_group first")
    size = dist.get_world_size()
    if dp < 1 or model < 1 or dp * model != size:
        raise ValueError(f"a ({dp}, {model}) mesh needs {dp * model} ranks, "
                         f"the process group has {size}")
    backend = str(dist.get_backend())
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = _device_for(backend, device)
    rank = dist.get_rank()
    d, m = divmod(rank, model)
    data_group = model_group = None
    for mm in range(model):
        g = dist.new_group([dd * model + mm for dd in range(dp)])
        if mm == m:
            data_group = g
    for dd in range(dp):
        g = dist.new_group([dd * model + mm for mm in range(model)])
        if dd == d:
            model_group = g
    world = RankWorld(dp, model, rank, backend, dev, data_group,
                      model_group)
    set_world(world)
    return world


def release_world(world: RankWorld) -> None:
    """Destroy the world's two groups (not the default group); it stops
    being the current world."""
    for g in (world.data_group, world.model_group):
        dist.destroy_process_group(g)
    if get_world() is world:
        set_world(None)


_WORLD: Optional[RankWorld] = None


def set_world(world: Optional[RankWorld]) -> None:
    global _WORLD
    _WORLD = world


def get_world() -> Optional[RankWorld]:
    """The process's current rank world (one a process), or None."""
    return _WORLD


# launchers' names of the axes (``context.py:20-49``): the port's model
# code reads no axis name, so these only carry what a launcher set
_EP_AXES: ContextVar[Tuple[str, ...]] = ContextVar(
    "ep_axes", default=("__disabled__",))
_BATCH_AXES: ContextVar[Tuple[str, ...]] = ContextVar(
    "batch_axes", default=("data",))


def set_expert_axes(axes: Tuple[str, ...]) -> None:
    _EP_AXES.set(tuple(axes))


def get_expert_axes() -> Tuple[str, ...]:
    return _EP_AXES.get()


def set_batch_axes(axes: Tuple[str, ...]) -> None:
    _BATCH_AXES.set(tuple(axes))


def get_batch_axes() -> Tuple[str, ...]:
    return _BATCH_AXES.get()


def maybe_constrain(x, spec):
    """The identity: tensors are placed by ``sharding.place``, not by a
    constraint."""
    return x


def constrain_logits(logits: torch.Tensor,
                     world: Optional[RankWorld] = None) -> torch.Tensor:
    """Vocab-sharded logits (..., V / model) gathered over the model group
    into (..., V): CAMD's sampler and scores read the whole distribution.
    ``world`` defaults to the current one; without a world, or with one
    model rank, the logits are whole already."""
    world = world or get_world()
    if world is None or world.model == 1:
        return logits
    return world.all_gather_model(logits, dim=-1)
