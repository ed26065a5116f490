# graphsage-reddit [gnn] n_layers=2 d_hidden=128 aggregator=mean
# sample_sizes=25-10 [arXiv:1706.02216; paper]
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig


def config_for(d_feat: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="graphsage-reddit",
        arch="graphsage",
        n_layers=2,
        d_hidden=128,
        d_feat=d_feat,
        n_classes=n_classes,
        sample_sizes=(25, 10),
    )


CONFIG = config_for(602, 41)  # reddit defaults
SMOKE = GNNConfig(
    name="graphsage-smoke", arch="graphsage", n_layers=2, d_hidden=16,
    d_feat=8, n_classes=4, sample_sizes=(5, 3),
)

SPEC = ArchSpec(
    arch_id="graphsage_reddit",
    family="gnn",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=GNN_SHAPES,
    notes="paper technique applies: core.sparse_certificate sparsifies the "
    "input graph / core.find_bridges reports failure-point edges before "
    "training (examples/gnn_certificate.py).",
)
