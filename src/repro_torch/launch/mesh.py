"""The rank mesh: the port's counterpart of the mesh axes the reference names.

The reference lays a device mesh over named axes and runs rank-local code
inside ``shard_map``; ``lax.axis_index``/``ppermute`` find a rank's place
and its neighbours. In the port every rank is a process of a
``torch.distributed`` group, and :class:`RankMesh` carries the same facts
explicitly: the mesh's shape and axis names, this process's position, the
global rank at every position, and the process group its messages go
through. Positions are row-major over the axes (the last axis varies
fastest), the order ``elastic.plan_factors`` lists its factors in.

Only ``make_mesh`` is ported here; the LM meshes (``make_production_mesh``,
``make_host_mesh``) belong to the LM's sharded training. Building a mesh
starts no process group: it reads the one the caller initialized (or none,
a world of one rank, where every axis has size 1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Union

__all__ = ["RankMesh", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """A cartesian mesh of ranks.

    ``shape``/``axes`` name the mesh, ``position`` is this process's place
    in it (row-major), ``ranks`` the global rank at each position, and
    ``group`` the process group (None: the default group, or no group in a
    world of one rank)."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    position: int = 0
    ranks: tuple[int, ...] = (0,)
    group: Any = None

    def _axis(self, axis: Union[int, str]) -> int:
        if isinstance(axis, str):
            if axis not in self.axes:
                raise ValueError(f"axis {axis!r} is not one of the mesh's axes {self.axes}")
            return self.axes.index(axis)
        if not 0 <= axis < len(self.shape):
            raise ValueError(f"axis {axis} out of range for a {len(self.shape)}-axis mesh")
        return int(axis)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple[int, ...]:
        """This process's coordinate on each axis."""
        out, position = [], self.position
        for n in reversed(self.shape):
            position, c = divmod(position, n)
            out.append(c)
        return tuple(reversed(out))

    def position_of(self, coords: Sequence[int]) -> int:
        pos = 0
        for c, n in zip(coords, self.shape):
            pos = pos * n + int(c)
        return pos

    def axis_size(self, axis: Union[int, str]) -> int:
        return self.shape[self._axis(axis)]

    def neighbor(self, axis: Union[int, str], direction: int,
                 periodic: bool = False) -> Optional[int]:
        """The global rank one step along ``axis`` in ``direction`` (+1 or
        -1), wrapping where the axis is ``periodic``; None past a
        non-periodic edge."""
        a = self._axis(axis)
        if direction not in (1, -1):
            raise ValueError(f"direction must be +1 or -1, got {direction}")
        c = list(self.coords)
        c[a] += direction
        if not 0 <= c[a] < self.shape[a]:
            if not periodic:
                return None
            c[a] %= self.shape[a]
        return self.ranks[self.position_of(c)]

    @property
    def rank(self) -> int:
        """This process's global rank."""
        return self.ranks[self.position]

    @property
    def backend(self) -> Optional[str]:
        """The group's transport (``"gloo"``, ``"nccl"``), None in a world
        of one rank without a process group."""
        import torch.distributed as dist

        return dist.get_backend(self.group) if dist.is_initialized() else None


def make_mesh(shape: Sequence[int], axes: Sequence[str], group=None) -> RankMesh:
    """The mesh ``shape`` over ``axes`` on the ranks of ``group`` (a
    ``torch.distributed`` process group; None: the default group). The
    mesh must cover the group exactly. Without an initialized process group
    the world is one rank, and every axis must have size 1."""
    import torch.distributed as dist

    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} repeat a name")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an axis of size < 1")
    if dist.is_initialized():
        world, position = dist.get_world_size(group), dist.get_rank(group)
        ranks = tuple(range(world)) if group is None else tuple(
            dist.get_global_rank(group, i) for i in range(world))
    else:
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not "
                             "initialized")
        world, position, ranks = 1, 0, (0,)
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} holds {math.prod(shape)} ranks, but the "
            f"process group has {world}"
            + ("" if dist.is_initialized() else
               " (no process group is initialized: a world of one rank, every axis "
               "of size 1)"))
    return RankMesh(shape, axes, position, ranks, group)
