"""The build-once, shape-bucketed, batched and incrementally updatable
query engine over the bridges pipeline and the analysis registry's kinds
and its continuous-batching scheduler (``repro.engine``)."""
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
from repro_torch.engine.scheduler import BridgeScheduler, Ticket
from repro_torch.engine.state import LiveState, SchedStats

__all__ = [
    "ANALYSIS_KINDS",
    "BatchedEdgeList",
    "BridgeEngine",
    "BridgeScheduler",
    "EngineStats",
    "LiveState",
    "ProgramCache",
    "SchedStats",
    "Ticket",
    "admission_bucket",
    "analyze_batch",
    "find_bridges_batch",
    "get_default_engine",
    "make_analysis_fn",
    "make_batched_pipeline",
    "make_query_fn",
    "normalize_kind",
]
