"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434]: MLA attention with kv_lora=512
compressed cache, MoE with 2 shared + 64 routed experts top-6, first layer
dense."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,               # dense-layer FFN width (layer 0)
    vocab=102400,
    kv_lora_rank=512,
    rope_dim=64,
    n_experts=64,
    top_k=6,
    d_expert=1408,
    n_shared_experts=2,
    first_dense=1,
    cut_layer=7,
    source="arXiv:2405.04434",
)
