# gatedgcn [gnn] n_layers=16 d_hidden=70 aggregator=gated [arXiv:2003.00982; paper]
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig


def config_for(d_feat: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="gatedgcn", arch="gatedgcn", n_layers=16, d_hidden=70,
        d_feat=d_feat, n_classes=n_classes,
    )


CONFIG = config_for(1433, 7)
SMOKE = GNNConfig(
    name="gatedgcn-smoke", arch="gatedgcn", n_layers=3, d_hidden=12,
    d_feat=8, n_classes=4,
)

SPEC = ArchSpec(
    arch_id="gatedgcn",
    family="gnn",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=GNN_SHAPES,
)
