"""Qwen2.5-14B [hf:Qwen/Qwen2.5-0.5B family card]: dense decoder, GQA with
QKV bias, no qk-norm, full attention (long_500k skipped — see DESIGN.md)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    qkv_bias=True,
    qk_norm=False,
    rope_theta=1_000_000.0,
    cut_layer=12,
    source="hf:Qwen/Qwen2.5-0.5B (family card, 14B variant)",
)
