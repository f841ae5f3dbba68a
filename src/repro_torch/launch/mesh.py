"""Device meshes over `torch.distributed` ranks: counterpart of
`repro.launch.mesh`.

`Mesh` is the port's mesh object: named axes over the ranks of the
running world, row-major (rank = the flat index of its coordinates, the
last axis fastest, as `jax.make_mesh` lays devices out), and one
process group for every set of axes — each rank's group along an axis
holds the ranks that differ from it only in that axis. `shape` maps
axis name to size, as the reference's `Mesh.shape` does, so the
sharding rules read either mesh the same way.

A mesh built where no process group is initialised (or whose size is
not the world's) is abstract: it has shapes and this rank's coordinates
(rank 0 unless given) but no groups — enough for specs
(`launch.specs`), not for collectives.

The production meshes (256 and 512 ranks) are built only under a world
of that size; the dry run, which will run them on a fake process group,
is their first user.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: Optional[int] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        world, world_rank = _world()
        self.rank = world_rank if rank is None else int(rank)
        self.coords: Dict[str, int] = dict(zip(
            self.axis_names,
            (int(c) for c in np.unravel_index(self.rank, tuple(shape)))))
        self._groups: Dict[Tuple[str, ...], Tuple[object, Tuple[int, ...]]] = {}
        if world > 1 and world == self.size:
            self._make_groups()

    def _make_groups(self) -> None:
        """One group per line of every non-empty set of axes. Every rank
        creates every group, in the same order, as `new_group` needs."""
        dims = tuple(self.shape[a] for a in self.axis_names)
        ranks = np.arange(self.size).reshape(dims)
        for k in range(1, len(dims) + 1):
            for axes in itertools.combinations(range(len(dims)), k):
                rest = [i for i in range(len(dims)) if i not in axes]
                lines = np.transpose(ranks, rest + list(axes)).reshape(
                    -1, math.prod(dims[i] for i in axes))
                names = tuple(self.axis_names[i] for i in axes)
                for line in lines:
                    members = tuple(int(r) for r in line)
                    group = dist.new_group(list(members))
                    if self.rank in members:
                        self._groups[names] = (group, members)

    def _key(self, axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        # the reference's axis order, whatever order the caller names them
        return tuple(a for a in self.axis_names if a in names)

    def group(self, axes):
        """This rank's process group along `axes` (a name or a tuple)."""
        key = self._key(axes)
        if key not in self._groups:
            raise RuntimeError(
                f"mesh {self.shape} has no process group for {axes!r} "
                "(an abstract mesh, or an axis it lacks)")
        return self._groups[key][0]

    def ranks(self, axes) -> Tuple[int, ...]:
        """Global ranks of this rank's line along `axes`, in axis order."""
        key = self._key(axes)
        if key in self._groups:
            return self._groups[key][1]
        if all(self.shape[a] == 1 for a in key):
            return (self.rank,)
        raise RuntimeError(f"mesh {self.shape} has no group for {axes!r}")

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._key(axes))

    def axis_index(self, axes) -> int:
        """This rank's index along `axes` (the first axis major)."""
        idx = 0
        for a in self._key(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model): needs a
    world of 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world()[0]
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{math.prod(shape)} ranks, got {world}")
    return Mesh(shape, axes)


def make_debug_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """Small (data, model) mesh over the ranks of the running world."""
    n = _world()[0]
    n_data = n_data if n_data is not None else n // n_model
    return Mesh((n_data, n_model), ("data", "model"))


def mesh_chips(mesh: Mesh) -> int:
    return mesh.size
