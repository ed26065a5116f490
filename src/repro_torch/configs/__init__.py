"""Architecture configs of the port, copied from ``src/repro/configs``.

Each ``ArchSpec`` carries the full-width config, a reduced smoke config
(CPU-sized) and its shape set. Only SASRec has come across; the other
architectures' configs wait for their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | graph
    config: Any
    smoke_config: Any
    shapes: dict[str, dict]
    skips: dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "bulk", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "n_candidates": 1_000_000},
}
