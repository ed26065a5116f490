"""The language-model family's module (``src/repro/models/transformer.py``).
Only ``Parallelism``, the mesh and its axis names that SASRec's multi-card
branches read, has come across; the decoder-only models wait for the
language-model slice."""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class Parallelism:
    """A ``torch.distributed.device_mesh.DeviceMesh`` and its logical axis
    mapping: the data-parallel axes and the tensor-parallel (model) axis.
    CPU tests without a mesh: ``Parallelism.none()``."""

    mesh: Any = None
    dp_axes: tuple = ("pod", "data")
    tp_axis: str = "model"

    @staticmethod
    def none():
        return Parallelism(mesh=None, dp_axes=(), tp_axis=None)
