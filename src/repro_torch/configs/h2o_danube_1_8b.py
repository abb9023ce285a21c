"""H2O-Danube-1.8B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention (4096), GQA kv=8.  Sub-quadratic via SWA -> long_500k is run."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    arch_type="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    sliding_window=4096,
    cut_layer=6,
    source="arXiv:2401.16818",
)
