# stablelm-12b [dense] 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352
# [hf:stabilityai/stablelm-2-1_6b; hf]
from repro_torch.configs import ArchSpec, LM_FULL_ATTENTION_SKIPS, LM_SHAPES
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    d_head=160,  # 5120 / 32
    qk_norm=False,
    rope_theta=1_000_000.0,
)

SMOKE = LMConfig(
    name="stablelm-12b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=512,
    d_head=16,
    param_dtype="float32",
    attn_chunk=16,
    loss_chunks=2,
)

SPEC = ArchSpec(
    arch_id="stablelm_12b",
    family="lm",
    config=CONFIG,
    smoke_config=SMOKE,
    shapes=LM_SHAPES,
    skips=LM_FULL_ATTENTION_SKIPS,
)
