# The paper's primary contribution: parallel bridge finding in dense graphs
# via distributed sparse certificates (Kumar & Singh, CS.DC 2021).
from repro_torch.core.api import (
    analyze,
    engine_for,
    find_bcc,
    find_bridge_tree,
    find_bridges,
    find_cuts,
    find_two_ecc,
)
from repro_torch.core.bridges_device import bridge_mask_device, bridges_device
from repro_torch.core.bridges_host import bridges_dfs, bridges_from_edgelist
from repro_torch.core.certificate import (
    certificate_capacity,
    merge_certificates,
    sparse_certificate,
)
from repro_torch.core.forest import connected_components, spanning_forest
from repro_torch.core.merge import build_distributed_bridges_fn, merged_certificate

__all__ = ["analyze", "bridge_mask_device", "bridges_device", "bridges_dfs",
           "bridges_from_edgelist", "build_distributed_bridges_fn",
           "certificate_capacity", "connected_components", "engine_for",
           "find_bcc", "find_bridge_tree", "find_bridges", "find_cuts",
           "find_two_ecc", "merge_certificates", "merged_certificate",
           "sparse_certificate", "spanning_forest"]
