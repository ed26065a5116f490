# pna [gnn] n_layers=4 d_hidden=75 aggregators=mean-max-min-std
# scalers=id-amp-atten [arXiv:2004.05718; paper]
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig


def config_for(d_feat: int, n_classes: int) -> GNNConfig:
    return GNNConfig(
        name="pna", arch="pna", n_layers=4, d_hidden=75,
        d_feat=d_feat, n_classes=n_classes,
    )


CONFIG = config_for(1433, 7)
SMOKE = GNNConfig(
    name="pna-smoke", arch="pna", n_layers=2, d_hidden=12, d_feat=8, n_classes=4
)

SPEC = ArchSpec(
    arch_id="pna",
    family="gnn",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=GNN_SHAPES,
)
