# The paper's own workload: dense graph bridge finding (Fig 2: |V|=1e5,
# |E|=1e7, M = mesh devices).
import dataclasses

from repro_torch.configs import PAPER_SHAPES, ArchSpec


@dataclasses.dataclass(frozen=True)
class BridgesConfig:
    name: str = "bridges-dense"
    n_nodes: int = 100_000
    n_edges: int = 10_000_000
    schedule: str = "paper"  # paper | xor | hierarchical
    final: str = "device"
    merge: str = "recertify"  # recertify (paper) | incremental (beyond-paper)


CONFIG = BridgesConfig()
SMOKE = BridgesConfig(name="bridges-smoke", n_nodes=200, n_edges=3000)

SPEC = ArchSpec(
    arch_id="bridges_dense",
    family="graph",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=PAPER_SHAPES,
    notes="the paper's contribution itself: partition -> per-machine sparse "
    "certificates -> log-phase merge -> PRAM bridge extraction, all one XLA "
    "program.",
)
