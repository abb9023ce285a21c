"""Qwen3-8B [hf:Qwen/Qwen3-8B]: dense decoder, GQA kv=8, qk-norm, no bias."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    cut_layer=9,
    source="hf:Qwen/Qwen3-8B",
)
