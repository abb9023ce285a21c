"""InternVL2-26B [arXiv:2404.16821]: InternViT-6B vision encoder + InternLM2
language model.  The vision tower + MLP projector are stubbed: input_specs()
supplies precomputed patch embeddings (batch, 256, d_model) — the allowed
modality carve-out.  This config is the InternLM2-20B language backbone."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    arch_type="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=92553,
    n_prefix_tokens=256,      # ViT patch embeddings per image
    cut_layer=12,
    source="arXiv:2404.16821",
)
