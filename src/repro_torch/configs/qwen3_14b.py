# qwen3-14b [dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
# qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]
from repro_torch.configs import ArchSpec, LM_FULL_ATTENTION_SKIPS, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen3-14b-smoke",
    n_layers=2,
    d_model=80,
    n_heads=5,  # keep the non-power-of-two head count of the full config
    n_kv_heads=1,
    d_ff=192,
    vocab=512,
    d_head=16,
    qk_norm=True,
    param_dtype="float32",
    attn_chunk=16,
    loss_chunks=2,
)

SPEC = ArchSpec(
    arch_id="qwen3_14b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=LM_SHAPES,
    skips=LM_FULL_ATTENTION_SKIPS,
    notes="40 heads on 16-way TP: head-count not divisible; TP shards the "
    "flattened head*dh dim (5120 % 16 == 0) instead of whole heads.",
)
