"""xLSTM-1.3B [arXiv:2405.04517]: 48 blocks, mLSTM with sLSTM interleaved
7:1, 4 heads, no separate MLP (d_ff=0 — the mLSTM block carries its own
2x up-projection)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,            # 7 mLSTM : 1 sLSTM
    cut_layer=12,
    source="arXiv:2405.04517",
)
