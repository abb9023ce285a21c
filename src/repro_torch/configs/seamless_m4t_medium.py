"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder transformer
backbone.  The audio frontend (mel-spectrogram + conformer feature
extractor) is stubbed: input_specs() supplies precomputed frame embeddings
of shape (batch, frames, d_model) — the allowed modality carve-out."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12,              # decoder layers
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    cut_layer=3,
    source="arXiv:2308.11596",
)
