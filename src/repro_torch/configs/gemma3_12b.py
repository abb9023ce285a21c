"""Gemma3-12B [hf:google/gemma-3-1b-pt family card]: dense decoder with
5 local(SWA-1024) : 1 global attention pattern, 128k context, head_dim 256,
qk-norm.  Sub-quadratic via the 5:1 SWA pattern -> long_500k is run."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,           # every 6th layer global => 5:1 local:global
    cut_layer=12,
    source="hf:google/gemma-3-1b-pt (family card, 12B variant)",
)
