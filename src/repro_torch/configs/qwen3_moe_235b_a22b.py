# qwen3-moe-235b-a22b [moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536
# vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]
from repro_torch.configs import ArchSpec, LM_FULL_ATTENTION_SKIPS, LM_SHAPES
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
)

SMOKE = LMConfig(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=0,
    vocab=512,
    d_head=16,
    qk_norm=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48),
    param_dtype="float32",
    attn_chunk=16,
    loss_chunks=2,
)

SPEC = ArchSpec(
    arch_id="qwen3_moe_235b_a22b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=LM_SHAPES,
    skips=LM_FULL_ATTENTION_SKIPS,
    notes="EP: 128 experts / 16-way model axis = 8 experts/device; "
    "fine-grained d_ff_expert=1536.",
)
