"""The trainer's mesh: ``--mesh`` parsed as the JAX CLI parses it, a rank's
place on it, and its process groups.

The counterpart of ``repro.launch.mesh`` and of the JAX CLI's ``--mesh``
(``repro/launch/train.py:722-730``): ``NxM`` is ``(data, model)``;
``PxNxM`` is ``(pod, data, model)``, whose worker axes flatten pod-major
into ``P*N`` workers as ``resolve_train_mesh`` flattens them
(``repro/launch/mesh.py:49-76``); under ``--topology hierarchical`` a 3-dim
mesh is ``(node, data, model)``, with ``N`` workers per node
(``repro/launch/train.py:763-772``); a 1-dim mesh is the model axis alone.

One rank per device of the mesh: rank ``w * M + m`` is model shard ``m`` of
DIANA worker ``w`` (the model index fastest, as in the JAX device order).
Each worker's ``M`` ranks form its *model group* (the tensor-parallel
collectives), and the ``W`` ranks holding shard ``m`` of every worker form
a *data group* (the workers that gather each other's payloads).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch.distributed as dist

from repro_torch.models.sharding import ModelGroup

__all__ = ["MeshSpec", "parse_mesh", "MeshGroups", "mesh_groups"]


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names (the JAX package's) and sizes."""

    axes: Tuple[str, ...]
    dims: Tuple[int, ...]

    def size(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 1

    @property
    def model(self) -> int:
        """M, the model axis."""
        return self.size("model")

    @property
    def n_workers(self) -> int:
        """The DIANA workers: every axis but ``model``, flattened."""
        return math.prod(d for a, d in zip(self.axes, self.dims) if a != "model")

    @property
    def world(self) -> int:
        return math.prod(self.dims)

    @property
    def node_size(self) -> int:
        """Workers per node on a ``(node, data, model)`` mesh, else 1."""
        return self.n_workers // self.size("node") if "node" in self.axes else 1

    def coords(self, rank: int) -> Tuple[int, int]:
        """``(worker, model shard)`` of ``rank``."""
        return divmod(rank, self.model)

    def rank(self, worker: int, shard: int) -> int:
        return worker * self.model + shard

    def __str__(self) -> str:
        return "x".join(map(str, self.dims)) + " (" + ", ".join(self.axes) + ")"


def parse_mesh(mesh: Optional[str], topology: Optional[str] = None) -> MeshSpec:
    """``--mesh`` -> :class:`MeshSpec` (no mesh: one worker, ``(1, 1)``)."""
    if not mesh:
        return MeshSpec(("data", "model"), (1, 1))
    dims = tuple(int(x) for x in mesh.split("x"))
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {mesh}: one to three positive sizes, e.g. 4x1, 2x2 or 2x1x2")
    axes = (("node", "data", "model") if topology == "hierarchical" and len(dims) == 3
            else ("pod", "data", "model"))[-len(dims):]
    return MeshSpec(axes, dims)


class MeshGroups(NamedTuple):
    """This rank's place on the mesh and its two process groups."""

    worker: int
    shard: int
    data: object          # the data group: shard ``shard`` of every worker
    model: ModelGroup     # the model group: this worker's shards


_GROUPS: dict = {}


def mesh_groups(spec: MeshSpec) -> MeshGroups:
    """This rank's :class:`MeshGroups` in the default group, whose size must
    be ``spec.world``.  ``dist.new_group`` is collective: every rank builds
    every group, in the same order, once per world."""
    world = dist.group.WORLD
    if dist.get_world_size() != spec.world:
        raise ValueError(f"--mesh {spec} needs {spec.world} ranks, the world has "
                         f"{dist.get_world_size()}")
    cached = _GROUPS.get(spec)
    if cached is not None and cached[0] is world:
        return cached[1]
    n, m = spec.n_workers, spec.model
    data = [dist.new_group([spec.rank(w, s) for w in range(n)]) for s in range(m)]
    model = [dist.new_group([spec.rank(w, s) for s in range(m)]) for w in range(n)]
    worker, shard = spec.coords(dist.get_rank())
    mine = MeshGroups(worker, shard, data[shard], ModelGroup(model[worker], m, shard))
    _GROUPS[spec] = (world, mine)
    return mine
