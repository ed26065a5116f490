"""Architecture configs of the port, copied from ``src/repro/configs``.

Each ``ArchSpec`` carries the full-width config, a reduced smoke config
(CPU-sized) and its shape set. ``get`` serves the ids whose modules have
come across: the dense language models ``qwen3_0_6b``, ``qwen3_14b`` and
``stablelm_12b``, the mixture-of-experts language models ``dbrx_132b`` and
``qwen3_moe_235b_a22b``, ``sasrec`` and ``bridges_dense`` (the paper's own
workload). The GNN configs and ``GNN_SHAPES`` wait for the GNN;
``ARCH_IDS`` and ``all_specs`` come with them, so that ``all_specs``
never raises.
"""
from __future__ import annotations

import dataclasses
import importlib
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


def get(arch_id: str) -> ArchSpec:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.SPEC


# ---------------------------------------------------------------- shape sets
LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}
LM_FULL_ATTENTION_SKIPS = {
    "long_500k": "pure full-attention arch: 524k decode needs sub-quadratic "
    "attention (assignment: skip for full-attention archs; DESIGN.md §4)",
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "bulk", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1, "n_candidates": 1_000_000},
}

PAPER_SHAPES = {
    # the paper's Fig 2 operating point: dense graph, machines = mesh devices
    "fig2_dense": {"kind": "bridges", "n_nodes": 100_000, "n_edges": 10_000_000},
    # denser stress cell (|E| = 4x Fig 2) used in Fig 4's rightmost regime
    "fig4_denser": {"kind": "bridges", "n_nodes": 100_000, "n_edges": 40_000_000},
}
