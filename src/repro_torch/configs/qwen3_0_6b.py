# qwen3-0.6b [dense] 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
# qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]
from repro_torch.configs import ArchSpec, LM_FULL_ATTENTION_SKIPS, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="qwen3-0.6b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=512,
    d_head=16,
    qk_norm=True,
    param_dtype="float32",
    attn_chunk=16,
    loss_chunks=2,
)

SPEC = ArchSpec(
    arch_id="qwen3_0_6b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=LM_SHAPES,
    skips=LM_FULL_ATTENTION_SKIPS,
    notes="paper technique inapplicable to dense-transformer layer math "
    "(graph algorithm); exercises the TP/DP distribution substrate.",
)
