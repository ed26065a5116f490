# sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
# interaction=self-attn-seq [arXiv:1808.09781; paper]
from repro_torch.configs import RECSYS_SHAPES, ArchSpec
from repro_torch.models.recsys import SASRecConfig

CONFIG = SASRecConfig(
    name="sasrec",
    n_items=1 << 20,  # 2^20-row table (taxonomy: 10^6..10^9), 16-way shardable
    d=50,
    n_blocks=2,
    n_heads=1,
    seq_len=50,
)

SMOKE = SASRecConfig(
    name="sasrec-smoke", n_items=2048, d=16, n_blocks=2, n_heads=1, seq_len=12
)

SPEC = ArchSpec(
    arch_id="sasrec",
    family="recsys",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=RECSYS_SHAPES,
    notes="paper technique inapplicable to the model math; shares the "
    "embedding/segment substrate. retrieval_cand scores via batched dot "
    "(no loop); serve_bulk uses chunked running top-k.",
)
