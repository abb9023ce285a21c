"""ModelConfig — single declarative description of every supported
architecture family (dense / moe / ssm / hybrid / encdec / vlm / audio and
the paper's CNNs).

A copy of the reference's ``repro/models/config.py`` (pure data), so that
the port imports nothing of the reference.  The port builds the dense
family; ``models/model.py::build_model`` names the queue item that ports
each other ``arch_type``."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio | cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0           # 0 => full attention everywhere
    global_every: int = 0             # gemma3-style: every k-th layer is global
    q_chunk: int = 0                  # scan-chunked attention for long seqs

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    first_dense: int = 0              # first k layers use a dense MLP
    capacity_factor: float = 1.25

    # MLA (deepseek)
    kv_lora_rank: int = 0
    rope_dim: int = 64

    # SSM / hybrid
    ssm_state: int = 0
    ssm_chunk: int = 256
    attn_every: int = 0               # hybrid: shared attention every k ssm blocks

    # xLSTM
    slstm_every: int = 0              # every k-th block is sLSTM (0 => all mLSTM)

    # encdec / multimodal
    n_enc_layers: int = 0
    n_prefix_tokens: int = 0          # vlm patches / audio frames consumed as embeddings

    # split-learning integration
    cut_layer: int = 1                # client-side block count (the SL cut)

    # execution
    remat: bool = False
    loss_chunk: int = 0               # scan-chunked xent (0 => full logits)
    dtype: str = "float32"
    # named beyond-baseline optimizations (set by the launch layer only —
    # they emit mesh-axis sharding constraints and require a mesh context):
    #   "moe_shard"    — token/capacity-sharded MoE dispatch (all-to-all)
    #   "mlstm_bf16_state" — bf16 inter-chunk mLSTM state carries
    # ("pigeon_psum" retired: the one-hot psum winner broadcast is now the
    #  RoundRunner's only strategy — see core/runner.py)
    optimizations: Tuple[str, ...] = ()

    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs accounting)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d
        per_attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        if self.kv_lora_rank:
            per_attn = (d * self.n_heads * (hd + self.rope_dim)
                        + d * (self.kv_lora_rank + self.rope_dim)
                        + self.kv_lora_rank * self.n_heads * hd * 2
                        + self.n_heads * hd * d)
        per_mlp = 3 * d * self.d_ff
        per_moe = self.n_experts * 3 * d * self.d_expert + d * self.n_experts \
            + self.n_shared_experts * 3 * d * self.d_expert
        n = emb * 2  # embed + head (untied)
        if self.arch_type in ("dense", "vlm"):
            n += self.n_layers * (per_attn + per_mlp)
        elif self.arch_type == "moe":
            n += self.first_dense * (per_attn + per_mlp)
            n += (self.n_layers - self.first_dense) * (per_attn + per_moe)
        elif self.arch_type == "ssm":
            di = 2 * d
            per_blk = d * (2 * di + 2 * self.ssm_state + di // 64) + di * d
            n += self.n_layers * per_blk
        elif self.arch_type == "hybrid":
            di = 2 * d
            per_blk = d * (2 * di + 2 * self.ssm_state + di // 64) + di * d
            n += self.n_layers * per_blk + 2 * per_attn
        elif self.arch_type in ("encdec", "audio"):
            n += (self.n_enc_layers or self.n_layers) * (per_attn + per_mlp)
            n += self.n_layers * (2 * per_attn + per_mlp)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        per_attn = d * (self.n_heads * self.resolved_head_dim) * 2 \
            + d * (self.n_kv_heads * self.resolved_head_dim) * 2
        if self.kv_lora_rank:
            hd = self.resolved_head_dim
            per_attn = (d * self.n_heads * (hd + self.rope_dim)
                        + d * (self.kv_lora_rank + self.rope_dim)
                        + self.kv_lora_rank * self.n_heads * hd * 2
                        + self.n_heads * hd * d)
        per_active_moe = (self.top_k + self.n_shared_experts) * 3 * d * self.d_expert \
            + d * self.n_experts
        n = self.vocab * d * 2
        n += self.first_dense * (per_attn + 3 * d * self.d_ff)
        n += (self.n_layers - self.first_dense) * (per_attn + per_active_moe)
        return n


def reduce_config(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
                  vocab: int = 512, n_experts: int = 4) -> ModelConfig:
    """Smoke-test variant of the same family (<=2 layers, d_model<=512,
    <=4 experts) that runs a real forward/train step on CPU."""
    d_model = min(d_model, 512)
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    scale = max(1, cfg.d_ff // max(cfg.d_model, 1)) if cfg.d_ff else 0
    changes = dict(
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=scale * d_model if cfg.d_ff else 0,
        vocab=min(cfg.vocab, vocab),
        head_dim=d_model // n_heads,
        q_chunk=0,
        ssm_chunk=64,
        remat=False,
        loss_chunk=0,
        dtype="float32",
        name=cfg.name + "-smoke",
    )
    if cfg.n_experts:
        changes.update(
            n_experts=min(cfg.n_experts, n_experts),
            top_k=min(cfg.top_k, 2),
            d_expert=d_model // 2,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            first_dense=min(cfg.first_dense, 1),
        )
    if cfg.kv_lora_rank:
        changes.update(kv_lora_rank=64, rope_dim=32)
    if cfg.ssm_state:
        changes.update(ssm_state=16)
    if cfg.attn_every:
        changes.update(attn_every=min(cfg.attn_every, 2))
    if cfg.slstm_every:
        changes.update(slstm_every=2)
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=2)
    if cfg.n_prefix_tokens:
        changes.update(n_prefix_tokens=8)
    if cfg.global_every:
        changes.update(global_every=2, sliding_window=16)
    elif cfg.sliding_window:
        changes.update(sliding_window=16)
    changes["cut_layer"] = 1
    return dataclasses.replace(cfg, **changes)
