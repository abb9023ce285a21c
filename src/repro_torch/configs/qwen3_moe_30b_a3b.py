"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: MoE decoder, 128 experts top-8,
GQA kv=4, qk-norm, expert FFN width 768."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                 # expert FFN width (no dense MLP layers)
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    top_k=8,
    d_expert=768,
    cut_layer=12,
    source="hf:Qwen/Qwen3-30B-A3B",
)
