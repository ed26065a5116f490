# Failure-point analysis on top of the bridges pipeline: articulation
# points, 2-edge-connected components, bridge tree and biconnected blocks on
# fixed-shape device buffers, the host Tarjan references, and the Analysis
# registry that makes each kind pluggable.
from repro_torch.connectivity.common import tour_state
from repro_torch.connectivity.device import (
    articulation_mask,
    articulation_points,
    bcc_blocks,
    block_labels_from_state,
    bridge_mask,
    bridge_tree,
    bridges,
    two_ecc_labels,
)
from repro_torch.connectivity.host import (
    articulation_points_dfs,
    bridge_tree_dfs,
    host_bcc_labels,
    two_ecc_labels_dfs,
)
from repro_torch.connectivity.registry import (
    ANALYSIS_KINDS,
    Analysis,
    analysis_kinds,
    certificate_fn,
    get_analysis,
    normalize_kind,
    register,
)

__all__ = [
    "tour_state",
    "bridge_mask",
    "bridges",
    "articulation_mask",
    "articulation_points",
    "bcc_blocks",
    "block_labels_from_state",
    "two_ecc_labels",
    "bridge_tree",
    "articulation_points_dfs",
    "two_ecc_labels_dfs",
    "bridge_tree_dfs",
    "host_bcc_labels",
    "ANALYSIS_KINDS",
    "Analysis",
    "analysis_kinds",
    "certificate_fn",
    "get_analysis",
    "normalize_kind",
    "register",
]
