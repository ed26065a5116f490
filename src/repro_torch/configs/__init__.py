"""Architecture configs of the port, copied from ``src/repro/configs``.

Each ``ArchSpec`` carries the full-width config, a reduced smoke config
(CPU-sized) and its shape set. Every id of ``ARCH_IDS`` has its module:
the dense language models, the mixture-of-experts language models, the
four graph networks, ``sasrec`` and ``bridges_dense`` (the paper's own
workload), so ``all_specs`` returns all eleven in the reference's order.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

ARCH_IDS = [
    "qwen3_0_6b",
    "stablelm_12b",
    "qwen3_14b",
    "dbrx_132b",
    "qwen3_moe_235b_a22b",
    "graphsage_reddit",
    "pna",
    "egnn",
    "gatedgcn",
    "sasrec",
    "bridges_dense",  # the paper's own workload
]


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


def all_specs() -> list[ArchSpec]:
    return [get(a) for a in ARCH_IDS]


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

GNN_SHAPES = {
    "full_graph_sm": {
        "kind": "full", "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433,
        "n_classes": 7,
    },
    "minibatch_lg": {
        "kind": "sampled", "n_nodes": 232965, "n_edges": 114615892,
        "batch_nodes": 1024, "fanout": (15, 10), "d_feat": 602, "n_classes": 41,
    },
    "ogb_products": {
        "kind": "full", "n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
        "n_classes": 47,
    },
    "molecule": {
        "kind": "batched", "n_nodes": 30, "n_edges": 64, "batch": 128,
        "d_feat": 16, "n_classes": 1,
    },
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
