"""The build-once, shape-bucketed, batched and incrementally updatable
query engine over the bridges pipeline and the analysis registry's kinds
(``repro.engine``, without its scheduler)."""
from repro_torch.engine.batched import (
    ANALYSIS_KINDS,
    BatchedEdgeList,
    make_analysis_fn,
    make_batched_pipeline,
    make_query_fn,
    normalize_kind,
)
from repro_torch.engine.dispatch import ProgramCache, admission_bucket
from repro_torch.engine.engine import (
    BridgeEngine,
    EngineStats,
    analyze_batch,
    find_bridges_batch,
    get_default_engine,
)
from repro_torch.engine.state import LiveState, SchedStats

__all__ = [
    "ANALYSIS_KINDS",
    "BatchedEdgeList",
    "BridgeEngine",
    "EngineStats",
    "LiveState",
    "ProgramCache",
    "SchedStats",
    "admission_bucket",
    "analyze_batch",
    "find_bridges_batch",
    "get_default_engine",
    "make_analysis_fn",
    "make_batched_pipeline",
    "make_query_fn",
    "normalize_kind",
]
