"""Device meshes and partition specs for the port's SPMD paths.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(the serving engine's ``("tp",)``, the hybrid group's
``dp``/``pp``/``sharding``/``sep``/``mp``). Every rank holds its own slice
of a sharded tensor and runs the same program on it; :func:`axis_size` and
:func:`axis_rank` are the one place that reads a mesh's dims.

:class:`PartitionSpec` is the port's own small copy of jax's: a tuple with
one entry per tensor dim — ``None`` (whole), a mesh dim name, or a tuple of
names — used by ``models.llama``'s sharding recipe and ``shard_params``.
:func:`axis_group` is the port's ``collective.Group`` over a mesh dim's
process group (the ranks that differ only along it), and :func:`spec_axes`
the mesh dims a spec entry names.
"""
from __future__ import annotations

from collections.abc import Mapping

__all__ = ["PartitionSpec", "P", "axis_size", "axis_rank", "is_mesh",
           "axis_group", "spec_axes"]


class PartitionSpec(tuple):
    """``PartitionSpec("tp", None)``: dim 0 split over mesh dim ``tp``,
    dim 1 whole. Equal to a tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def is_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def _names(mesh):
    if is_mesh(mesh):
        return tuple(mesh.mesh_dim_names or ())
    raise TypeError(
        f"mesh must be a torch.distributed.device_mesh.DeviceMesh with "
        f"named dims, got {type(mesh).__name__}")


def axis_size(mesh, name: str) -> int:
    """The size of mesh dim ``name`` (1 when the mesh has no such dim or
    is None). ``mesh`` is a ``DeviceMesh``, or a mapping of dim name to
    size (the shapes alone, for planning without a process group); anything
    else raises ``TypeError``."""
    if mesh is None:
        return 1
    if isinstance(mesh, Mapping):
        return int(mesh.get(name, 1))
    names = _names(mesh)
    return int(mesh.size(names.index(name))) if name in names else 1


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along mesh dim ``name`` (0 when the mesh has
    no such dim, is None or is a mapping of sizes)."""
    if mesh is None or isinstance(mesh, Mapping):
        return 0
    names = _names(mesh)
    return int(mesh.get_local_rank(name)) if name in names else 0


def spec_axes(entry) -> tuple:
    """The mesh dim names of one spec entry (``None``, a name or a tuple
    of names)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


_GROUPS: dict = {}


def axis_group(mesh, name: str):
    """The ``collective.Group`` of this rank along mesh dim ``name``: its
    members' global ranks and the dim's torch process group (one object
    per (mesh, dim), kept for the process's life)."""
    key = (id(mesh), name)
    g = _GROUPS.get(key)
    if g is None or g[0] is not mesh:
        import torch.distributed as dist

        from .collective import Group

        pg = mesh.get_group(name)
        g = _GROUPS[key] = (mesh, Group(dist.get_process_group_ranks(pg),
                                        pg))
    return g[1]
