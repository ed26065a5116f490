# dbrx-132b [moe] 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
# MoE 16e top-4, fine-grained [hf:databricks/dbrx-base; unverified]
from repro_torch.configs import ArchSpec, LM_FULL_ATTENTION_SKIPS, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=0,
    vocab=100352,
    d_head=128,
    qk_norm=False,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
)

SMOKE = LMConfig(
    name="dbrx-132b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    d_head=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96),
    param_dtype="float32",
    attn_chunk=16,
    loss_chunks=2,
)

SPEC = ArchSpec(
    arch_id="dbrx_132b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=LM_SHAPES,
    skips=LM_FULL_ATTENTION_SKIPS,
    notes="EP: 16 experts over 16-way model axis -> 1 expert/device.",
)
