"""Zamba2-1.2B [arXiv:2411.15242]: hybrid Mamba2 backbone with shared
attention blocks interleaved every 6 SSM layers (see DESIGN.md for the
weight-tying simplification)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=38,              # mamba2 layers
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,            # MHA inside the shared attention block
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm_state=64,
    attn_every=6,
    cut_layer=10,
    source="arXiv:2411.15242",
)
