from repro_torch.core.api import (
    analyze,
    find_bcc,
    find_bridge_tree,
    find_bridges,
    find_cuts,
    find_two_ecc,
)
from repro_torch.core.merge import build_distributed_bridges_fn, merged_certificate

__all__ = ["analyze", "build_distributed_bridges_fn", "find_bcc",
           "find_bridge_tree", "find_bridges", "find_cuts", "find_two_ecc",
           "merged_certificate"]
