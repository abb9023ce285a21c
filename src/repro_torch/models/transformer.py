"""Decoder assembly: the reference's ``repro/models/transformer.py`` for the
dense family (``arch_type="dense"``, the ``attn_mlp`` stack kind) and xLSTM
(``arch_type="ssm"`` with ``slstm_every``, the ``mlstm`` and ``slstm``
kinds).

The model is an ordered list of homogeneous :class:`BlockStack`\\ s.  Where
the reference stacks a stack's layers on a leading axis and runs them under
``lax.scan``, a port stack keeps them in an ``nn.ModuleList`` and loops;
``convert.py`` maps the one onto the other.  A stack's per-layer sliding
windows (gemma3's local:global pattern) ride in ``meta["window"]`` as ints
and reach the attention kernels as a runtime argument; the xLSTM kinds have
no meta.

A stack's decode cache is a dict of tensors with the layer axis first, the
reference's layout: {"k", "v"} of (n, B, max_seq, Hkv, D) for ``attn_mlp``,
the mixers' recurrent state for ``mlstm`` and ``slstm``
(``xlstm.init_*_cache``); layer i updates its slice in place.  A stack
splits at the split-learning cut by slicing its layer list
(:func:`slice_stack`), which shares the layers.

The batched round's cluster-stacked LM (``model.StackedModel``) builds its
stacks of :class:`StackedAttnMLPLayer`\\ s by :func:`build_stacked_stacks`
and runs them through the same :func:`run_stack` (dense only).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import xlstm
from .attention import GQA, AttnConfig, StackedGQA, init_kv_cache
from .blocks import DTYPES, RMSNorm, StackedRMSNorm, StackedSwiGLU, SwiGLU
from .config import ModelConfig

#: where each unported arch_type comes: its ROADMAP.md Queue A item and slice
UNPORTED = {
    "vlm": (7, "the vlm slice (the patch prefix on the dense stack)"),
    "moe": (8, "the MLA/MoE slice"),
    "ssm": (9, "the SSM slice (Mamba2, slstm_every = 0; xLSTM is ported)"),
    "hybrid": (9, "the SSM slice"),
    "encdec": (10, "the encdec slice"),
    "audio": (10, "the encdec slice"),
}


def not_ported(arch_type: str) -> NotImplementedError:
    if arch_type in UNPORTED:
        item, where = UNPORTED[arch_type]
        where = f"ROADMAP.md Queue A item {item}, {where}"
    else:
        where = "no slice: unknown arch_type"
    return NotImplementedError(
        f"arch_type {arch_type!r} is not ported yet: {where}; "
        f"the port builds arch_type='dense' and xLSTM (arch_type='ssm' with slstm_every)")


def attn_cfg(cfg: ModelConfig) -> AttnConfig:
    """The attention's widths; each layer's window comes from
    :func:`_layer_windows`."""
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)


def xlstm_cfg(cfg: ModelConfig) -> xlstm.XLSTMConfig:
    return xlstm.XLSTMConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, chunk=cfg.ssm_chunk,
        state_dtype=("bfloat16" if "mlstm_bf16_state" in cfg.optimizations else "float32"))


class AttnMLPLayer(nn.Module):
    """Pre-norm decoder layer: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        kw = dict(dtype=DTYPES[cfg.dtype], device=device)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.attn = GQA(attn_cfg(cfg), **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in (self.ln1, self.attn, self.ln2, self.mlp):
            mod.reset_parameters(generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions, window)
        return x + self.mlp(self.ln2(x))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               window: int) -> torch.Tensor:
        x = x + self.attn.decode(self.ln1(x), cache, index, window)
        return x + self.mlp(self.ln2(x))


class StackedAttnMLPLayer(nn.Module):
    """n slots' :class:`AttnMLPLayer` (the same parameters, each with a
    leading slot axis): x (n, B, S, d_model)."""

    def __init__(self, cfg: ModelConfig, n: int, device=None):
        super().__init__()
        kw = dict(dtype=DTYPES[cfg.dtype], device=device)
        self.ln1 = StackedRMSNorm(n, cfg.d_model, **kw)
        self.attn = StackedGQA(attn_cfg(cfg), n, **kw)
        self.ln2 = StackedRMSNorm(n, cfg.d_model, **kw)
        self.mlp = StackedSwiGLU(n, cfg.d_model, cfg.d_ff, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions, window)
        return x + self.mlp(self.ln2(x))


class XLSTMBlock(nn.Module):
    """Pre-norm xLSTM block of kind ``mlstm`` or ``slstm``: ``x + mixer(ln(x))``."""

    MIXERS = {"mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        kw = dict(dtype=DTYPES[cfg.dtype], device=device)
        self.ln = RMSNorm(cfg.d_model, **kw)
        self.mixer = self.MIXERS[kind](xlstm_cfg(cfg), **kw)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln.reset_parameters()
        self.mixer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mixer(self.ln(x))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        return x + self.mixer.decode(self.ln(x), cache)


class BlockStack(nn.Module):
    """``n`` layers of one ``kind``, with per-layer metadata in ``meta``."""

    def __init__(self, kind: str, layers: List[nn.Module], meta: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.kind = kind
        self.n = len(layers)
        self.layers = nn.ModuleList(layers)
        self.meta = dict(meta or {})


def _layer_windows(cfg: ModelConfig) -> Tuple[int, ...]:
    """Per-layer sliding window sizes (0 = global)."""
    if cfg.global_every:
        return tuple(0 if (i + 1) % cfg.global_every == 0 else cfg.sliding_window
                     for i in range(cfg.n_layers))
    return (cfg.sliding_window,) * cfg.n_layers


def _layer(cfg: ModelConfig, kind: str, device) -> nn.Module:
    return AttnMLPLayer(cfg, device) if kind == "attn_mlp" else XLSTMBlock(cfg, kind, device)


def build_stacks(cfg: ModelConfig, plan, device=None) -> List[BlockStack]:
    """The stacks of ``plan`` (``model.build_plan(cfg)``), parameters
    allocated uninitialised on ``device``."""
    return [BlockStack(sp.kind, [_layer(cfg, sp.kind, device) for _ in range(sp.n)], sp.meta)
            for sp in plan]


def build_stacked_stacks(cfg: ModelConfig, plan, n: int, device=None) -> List[BlockStack]:
    """The stacks of ``plan`` with n slots a layer (zeroed parameters on
    ``device``); ``plan`` holds ``attn_mlp`` stacks only."""
    return [BlockStack(sp.kind, [StackedAttnMLPLayer(cfg, n, device) for _ in range(sp.n)],
                       sp.meta) for sp in plan]


def _layer_args(stack: BlockStack, *head) -> List[tuple]:
    """Each layer's arguments after x (and its cache): ``head`` and the
    layer's window for an ``attn_mlp`` stack, nothing for the xLSTM kinds."""
    if stack.kind == "attn_mlp":
        return [(*head, window) for window in stack.meta["window"]]
    return [()] * stack.n


def run_stack(stack: BlockStack, x: torch.Tensor, positions: torch.Tensor,
              remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss_sum); a dense stack has no auxiliary loss.  With
    ``remat`` (``cfg.remat``) each layer is checkpointed when a gradient is
    being recorded: its activations are recomputed in the backward, as the
    reference's ``jax.checkpoint`` of the scanned layer body does."""
    ckpt = remat and torch.is_grad_enabled()
    for layer, args in zip(stack.layers, _layer_args(stack, positions)):
        if ckpt:
            x = checkpoint(layer, x, *args, use_reentrant=False)
        else:
            x = layer(x, *args)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def slice_stack(stack: BlockStack, lo: int, hi: int) -> BlockStack:
    """Layers [lo, hi) of ``stack`` as a stack of their own, sharing the
    layer modules (the reference's ``_slice_meta`` of the plan plus the
    params slice)."""
    meta = {k: v[lo:hi] for k, v in stack.meta.items()}
    return BlockStack(stack.kind, list(stack.layers[lo:hi]), meta)


def init_stack_cache(cfg: ModelConfig, stack: BlockStack, batch: int, max_seq: int,
                     dtype: torch.dtype, device=None) -> Dict[str, torch.Tensor]:
    """A stack's zeroed decode cache: the KV cache in ``dtype``, or the
    xLSTM kinds' recurrent state (f32, independent of ``max_seq``)."""
    if stack.kind == "mlstm":
        return xlstm.init_mlstm_cache(batch, xlstm_cfg(cfg), device, stack.n)
    if stack.kind == "slstm":
        return xlstm.init_slstm_cache(batch, xlstm_cfg(cfg), device, stack.n)
    return init_kv_cache(stack.n, batch, max_seq, attn_cfg(cfg), dtype, device)


def decode_stack(stack: BlockStack, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 index: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step through a stack.  x: (B, 1, d_model); the cache is
    written in place and returned."""
    for i, (layer, args) in enumerate(zip(stack.layers, _layer_args(stack, index))):
        x = layer.decode(x, {name: t[i] for name, t in cache.items()}, *args)
    return x, cache


__all__ = ["AttnMLPLayer", "BlockStack", "StackedAttnMLPLayer", "XLSTMBlock", "attn_cfg",
           "build_stacked_stacks", "build_stacks", "decode_stack", "init_stack_cache",
           "not_ported", "run_stack", "slice_stack", "xlstm_cfg"]
