from repro_torch.core.api import (
    analyze,
    find_bcc,
    find_bridge_tree,
    find_bridges,
    find_cuts,
    find_two_ecc,
)

__all__ = ["analyze", "find_bcc", "find_bridge_tree", "find_bridges",
           "find_cuts", "find_two_ecc"]
