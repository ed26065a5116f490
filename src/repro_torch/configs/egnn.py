# egnn [gnn] n_layers=4 d_hidden=64 equivariance=E(n) [arXiv:2102.09844; paper]
from repro_torch.configs import GNN_SHAPES, ArchSpec
from repro_torch.models.gnn import GNNConfig


def config_for(d_feat: int, n_classes: int = 1) -> GNNConfig:
    return GNNConfig(
        name="egnn", arch="egnn", n_layers=4, d_hidden=64,
        d_feat=d_feat, n_classes=n_classes,
    )


CONFIG = config_for(16)
SMOKE = GNNConfig(
    name="egnn-smoke", arch="egnn", n_layers=2, d_hidden=16, d_feat=8
)

SPEC = ArchSpec(
    arch_id="egnn",
    family="gnn",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=GNN_SHAPES,
    notes="E(n)-equivariant: coordinate inputs synthesized for the graph "
    "shapes (scalar-distance MPNN regime, no spherical harmonics).",
)
