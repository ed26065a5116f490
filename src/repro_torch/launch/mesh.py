"""Mesh construction, ported from ``src/repro/launch/mesh.py`` over
``torch.distributed.device_mesh.init_device_mesh``.

Functions, never module-level meshes, so importing this module starts no
process group. Each builds a ``DeviceMesh`` over the default process
group, which must hold exactly the mesh's number of ranks (with
``init_device_mesh`` initialising it from the environment when it is not
yet). ``device_type`` is ``"cuda"`` unless the caller names another
(``"cpu"`` for a gloo group).

A partition spec is a tuple with one entry per tensor dimension: ``None``,
a mesh axis name or a tuple of names (``jax.sharding.PartitionSpec``'s
entries). ``spec_placements`` turns it into a ``DTensor``'s placements.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (16, 16) = (data, model), 256 ranks.
    Multi-pod: (2, 16, 16) = (pod, data, model), 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_pp_mesh(*, multi_pod: bool = False,
                 device_type: str = "cuda") -> DeviceMesh:
    """Pipeline-parallel mesh: (pipe, data, model). Single pod: (4, 4, 16)
    = 256 ranks, 4 stages; multi-pod: (8, 4, 16) = 512 ranks, the pipe
    axis spanning pods (a stage boundary moves one activation block per
    microbatch tick, the cheapest traffic to put between pods)."""
    shape = (8, 4, 16) if multi_pod else (4, 4, 16)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=("pipe", "data", "model"))


def make_test_mesh(n: int = 8, axes=("data", "model"), shape=None,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small mesh for tests: (n // 2, 2) over two axes, else (n,)."""
    if shape is None:
        shape = (n // 2, 2) if len(axes) == 2 else (n,)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def dp_axes_for(mesh: DeviceMesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a not in ("model", "pipe"))


def machine_axes_for(mesh: DeviceMesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def spec_placements(mesh: DeviceMesh, spec: tuple) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: per mesh
    dimension, ``Shard(d)`` if the spec puts that axis on tensor dimension
    ``d``, else ``Replicate()``. Axes the mesh lacks are dropped, as the
    reference's ``shard`` drops them. A dimension split over several axes
    must list them in the mesh's order (``DTensor`` splits in that
    order)."""
    names = tuple(mesh.mesh_dim_names)
    dim_of = {}
    for d, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else tuple(part or ())
        kept = [a for a in axes if a in names]
        if kept != sorted(kept, key=names.index):
            raise ValueError(f"spec {spec}: axes {tuple(kept)} of dimension "
                             f"{d} are not in the mesh's order {names}")
        for a in kept:
            if a in dim_of:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            dim_of[a] = d
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]
