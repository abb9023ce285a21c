"""Decoder and encoder assembly: the reference's
``repro/models/transformer.py`` for every architecture family: the dense
family and the vlm (``arch_type="dense"``/``"vlm"``, the ``attn_mlp`` stack
kind), MoE (``arch_type="moe"``: ``first_dense`` layers of the
``dense_mlp`` kind, then the ``moe`` kind, each with GQA or, where
``kv_lora_rank`` is set, MLA), xLSTM (``arch_type="ssm"`` with
``slstm_every``, the ``mlstm`` and ``slstm`` kinds), Mamba2 (``ssm``
without it, the ``mamba`` kind), the Zamba2 hybrid (``arch_type="hybrid"``:
``mamba`` stacks with a ``shared_attn`` block between them) and the
encoder-decoder (``arch_type="encdec"``/``"audio"``: the ``enc`` kind in
``model.Encoder``, the ``dec_cross`` kind in the decoder).

The model is an ordered list of homogeneous :class:`BlockStack`\\ s.  Where
the reference stacks a stack's layers on a leading axis and runs them under
``lax.scan``, a port stack keeps them in an ``nn.ModuleList`` and loops;
``convert.py`` maps the one onto the other.  An ``attn_mlp`` stack's
per-layer sliding windows (gemma3's local:global pattern) ride in
``meta["window"]`` as ints, the MoE kinds and ``dec_cross`` take
``cfg.sliding_window``; each layer holds its own and hands it to the
attention kernels as a runtime argument; ``shared_attn`` attends over every
earlier position; the mixer kinds have no meta.  A ``shared_attn`` stack is
one block whose parameters and cache carry no layer axis in the reference
(every other kind's do); it counts as one layer toward the cut.

A stack's decode cache is a dict of tensors with the layer axis first, the
reference's layout: {"k", "v"} of (n, B, max_seq, Hkv, D) for ``attn_mlp``
(and the GQA ``dense_mlp``/``moe`` and the decoder's self-attention in
``dec_cross``), {"latent", "k_rope"} for the MLA ones, the mixers'
recurrent state for ``mlstm``, ``slstm`` and ``mamba``
(``xlstm.init_*_cache``, ``ssm.init_ssm_cache``); layer i updates its slice
in place.  A ``shared_attn`` cache is one (B, max_seq, Hkv, D) pair.  A stack
splits at the split-learning cut by slicing its layer list
(:func:`slice_stack`), which shares the layers.

A decoder layer's forward returns (x, aux): a ``moe`` layer its router's
auxiliary loss, the others None; :func:`run_stack` sums them (the
reference's ``run_stack``).  The other kinds return x.  A ``dec_cross``
layer also takes the encoder's memory, which its cross-attention reads (B5
non-causal, in decode too: the reference recomputes the memory's K and V
every step).

The batched round's cluster-stacked LM (``model.StackedModel``) builds its
stacks of :class:`DecoderLayer`\\ s and :class:`AttnBlock`\\ s of stacked
parts and :class:`StackedMixerBlock`\\ s by :func:`build_stacked_stacks`
and runs them through the same :func:`run_stack` (a stacked ``moe`` layer's
aux is (n,), one a slot), the encoder-decoder's layers too (the launch
round step over its slots; ``core.split.from_lm`` takes no
encoder-decoder, as the reference's sends tokens only).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import ssm, xlstm
from .attention import (GQA, MLA, AttnConfig, MLAConfig, StackedGQA, StackedMLA,
                        gqa_cross_forward, init_kv_cache, init_mla_cache)
from .blocks import DTYPES, RMSNorm, StackedRMSNorm, StackedSwiGLU, SwiGLU
from .config import ModelConfig
from .moe import MoE, MoEConfig, StackedMoE
from .parallel import Panels

#: the encoder-decoder's arch_types
ENCDEC = ("encdec", "audio")


def not_ported(arch_type: str) -> NotImplementedError:
    """The refusal of an arch_type the reference does not have."""
    return NotImplementedError(
        f"unknown arch_type {arch_type!r}: the port builds arch_type 'dense', 'vlm', 'moe', "
        f"'ssm' (xLSTM or Mamba2), 'hybrid', 'encdec' and 'audio'")


def attn_cfg(cfg: ModelConfig) -> AttnConfig:
    """The attention's widths; each layer's window comes from
    :func:`_layer_windows`."""
    return AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)


def mla_cfg(cfg: ModelConfig) -> MLAConfig:
    return MLAConfig(d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.resolved_head_dim,
                     kv_lora_rank=cfg.kv_lora_rank, rope_dim=cfg.rope_dim,
                     rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk)


def moe_cfg(cfg: ModelConfig) -> MoEConfig:
    """The MoE's widths; ``"moe_shard"`` sets the reference's shard-local
    dispatch (``shard``, 16 groups), on one card or over a mesh."""
    shard = "moe_shard" in cfg.optimizations
    return MoEConfig(d_model=cfg.d_model, d_expert=cfg.d_expert, n_experts=cfg.n_experts,
                     top_k=cfg.top_k, n_shared=cfg.n_shared_experts,
                     capacity_factor=cfg.capacity_factor, shard=shard,
                     shard_groups=16 if shard else 0)


def xlstm_cfg(cfg: ModelConfig) -> xlstm.XLSTMConfig:
    return xlstm.XLSTMConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, chunk=cfg.ssm_chunk,
        state_dtype=("bfloat16" if "mlstm_bf16_state" in cfg.optimizations else "float32"))


def ssm_cfg(cfg: ModelConfig) -> ssm.SSMConfig:
    return ssm.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state, chunk=cfg.ssm_chunk)


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer of the ``attn_mlp``, ``dense_mlp`` and ``moe``
    kinds: ``x + attn(ln1(x))``, then ``x + ffn(ln2(x))``.  The attention
    is GQA, or MLA where ``kv_lora_rank`` is set, at the layer's
    ``window``; the FFN a SwiGLU (registered as ``mlp``) or a MoE
    (``moe``).  Built by :func:`_layer` from plain parts or, for the
    cluster-stacked LM, from stacked ones (a leading slot axis on x and on
    every parameter).  ``forward`` returns (x, aux): the MoE's router loss
    ((n,) stacked), else None."""

    def __init__(self, ln1: nn.Module, attn: nn.Module, ln2: nn.Module, ffn: nn.Module,
                 window: int):
        super().__init__()
        self.window = window
        self.ln1, self.attn, self.ln2 = ln1, attn, ln2
        self.routed = isinstance(ffn, (MoE, StackedMoE))
        self.add_module("moe" if self.routed else "mlp", ffn)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def _ffn(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if self.routed:
            out, aux = self.moe(self.ln2(x))
            return x + out, aux
        return x + self.mlp(self.ln2(x)), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return self._ffn(x + self.attn(self.ln1(x), positions, self.window))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               panels: Optional[Panels] = None) -> torch.Tensor:
        return self._ffn(x + self.attn.decode(self.ln1(x), cache, index, self.window,
                                              panels))[0]


#: the mixer kinds: (mixer, its stacked form, its config)
MIXERS = {"mlstm": (xlstm.MLSTM, xlstm.StackedMLSTM, xlstm_cfg),
          "slstm": (xlstm.SLSTM, xlstm.StackedSLSTM, xlstm_cfg),
          "mamba": (ssm.Mamba2, ssm.StackedMamba2, ssm_cfg)}


#: the mixer kinds whose heads split over ``model``; the sLSTM's recurrence
#: couples its heads, so it runs whole on each model rank
SPLIT_MIXERS = ("mlstm", "mamba")


def _mixer_kw(kind: str, par) -> Dict[str, Any]:
    return {"par": par} if kind in SPLIT_MIXERS else {}


class MixerBlock(nn.Module):
    """Pre-norm block of a mixer kind (``mlstm``, ``slstm``, ``mamba``):
    ``x + mixer(ln(x))``; with ``par`` an mLSTM's or Mamba2's heads over
    ``model``."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None, par=None):
        super().__init__()
        kw = dict(dtype=DTYPES[cfg.dtype], device=device)
        mixer, _, mixer_cfg = MIXERS[kind]
        self.ln = RMSNorm(cfg.d_model, **kw)
        self.mixer = mixer(mixer_cfg(cfg), **kw, **_mixer_kw(kind, par))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln.reset_parameters()
        self.mixer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mixer(self.ln(x))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor]) -> torch.Tensor:
        return x + self.mixer.decode(self.ln(x), cache)


class StackedMixerBlock(nn.Module):
    """n slots' :class:`MixerBlock` (the same parameters, each with a
    leading slot axis): x (n, B, S, d_model); ``par`` as
    :class:`MixerBlock`'s."""

    def __init__(self, cfg: ModelConfig, kind: str, n: int, device=None, par=None):
        super().__init__()
        kw = dict(dtype=DTYPES[cfg.dtype], device=device)
        _, stacked, mixer_cfg = MIXERS[kind]
        self.ln = StackedRMSNorm(n, cfg.d_model, **kw)
        self.mixer = stacked(mixer_cfg(cfg), n, **kw, **_mixer_kw(kind, par))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.mixer(self.ln(x))


class AttnBlock(nn.Module):
    """Zamba2's shared attention block (``shared_attn``): ``x + attn(ln(x))``,
    GQA over every earlier position (window 0).  Built from plain parts or,
    for the cluster-stacked LM, from stacked ones."""

    def __init__(self, ln: nn.Module, attn: nn.Module):
        super().__init__()
        self.ln, self.attn = ln, attn

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln.reset_parameters()
        self.attn.reset_parameters(generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return x + self.attn(self.ln(x), positions, 0)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               panels: Optional[Panels] = None) -> torch.Tensor:
        return x + self.attn.decode(self.ln(x), cache, index, 0, panels)


def _parts(cfg: ModelConfig, device, par, n: Optional[int]):
    """Makers of a layer's norm, GQA and SwiGLU (with ``par``): plain, or
    of n slots."""
    kw = dict(dtype=DTYPES[cfg.dtype], device=device)
    d, acfg = cfg.d_model, attn_cfg(cfg)
    if n is None:
        return (lambda: RMSNorm(d, **kw), lambda: GQA(acfg, **kw, par=par),
                lambda: SwiGLU(d, cfg.d_ff, **kw, par=par))
    return (lambda: StackedRMSNorm(n, d, **kw), lambda: StackedGQA(acfg, n, **kw, par=par),
            lambda: StackedSwiGLU(n, d, cfg.d_ff, **kw, par=par))


class EncoderLayer(nn.Module):
    """The encoder's bidirectional layer (``enc``): ``x + attn(ln1(x))`` over
    every position (rope on 0..S-1, no qk-norm even where the config sets
    it; B5 non-causal), then ``x + mlp(ln2(x))``; with ``par`` the
    attention's heads and the SwiGLU's columns over ``model``; with ``n``
    its cluster-stacked form (x (n, B, S, d_model))."""

    def __init__(self, cfg: ModelConfig, device=None, par=None, n: Optional[int] = None):
        super().__init__()
        norm, attn, mlp = _parts(cfg, device, par, n)
        self.ln1 = norm()
        self.attn = attn()
        self.ln2 = norm()
        self.mlp = mlp()

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn.encode(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class CrossDecoderLayer(nn.Module):
    """The encoder-decoder's decoder layer (``dec_cross``): causal
    self-attention, cross-attention over the encoder's memory, SwiGLU, each
    pre-norm (``ln1``, ``ln_x``, ``ln2``); with ``par`` each attention's
    heads (the cross-attention's K and V the rank's heads of the memory,
    which is whole on every rank) and the SwiGLU's columns over
    ``model``; with ``n`` its cluster-stacked form (x and the memory
    (n, B, S, d_model))."""

    def __init__(self, cfg: ModelConfig, window: int, device=None, par=None,
                 n: Optional[int] = None):
        super().__init__()
        norm, attn, mlp = _parts(cfg, device, par, n)
        self.window = window
        self.ln1 = norm()
        self.self_attn = attn()
        self.ln_x = norm()
        self.cross_attn = attn()
        self.ln2 = norm()
        self.mlp = mlp()

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            mod.reset_parameters(generator)

    def _tail(self, x: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        x = x + gqa_cross_forward(self.cross_attn, self.ln_x(x), memory)
        return x + self.mlp(self.ln2(x))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, memory: torch.Tensor
                ) -> torch.Tensor:
        return self._tail(x + self.self_attn(self.ln1(x), positions, self.window), memory)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor], index: int,
               memory: torch.Tensor, panels: Optional[Panels] = None) -> torch.Tensor:
        return self._tail(x + self.self_attn.decode(self.ln1(x), cache, index, self.window,
                                                    panels), memory)


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


#: the kinds whose layers take x alone
X_ONLY_KINDS = tuple(MIXERS) + ("enc",)


def _layer(cfg: ModelConfig, kind: str, window: int, device, n: Optional[int] = None,
           par=None) -> nn.Module:
    """A layer of ``kind`` (at ``window``, for the attention kinds); with
    ``n``, its cluster-stacked form of n slots; with ``par``
    (``models.parallel``), this rank's shards of every kind: the GQA and
    MLA heads, the SwiGLU's columns and the MoE's experts of the
    ``attn_mlp``, ``dense_mlp``, ``moe``, ``shared_attn``, ``enc`` and
    ``dec_cross`` kinds, the mLSTM's and Mamba2's heads; the sLSTM, and any
    layer whose dim the model axis does not divide, whole on each rank."""
    if kind in MIXERS:
        return (MixerBlock(cfg, kind, device, par) if n is None
                else StackedMixerBlock(cfg, kind, n, device, par))
    if kind in ("enc", "dec_cross"):
        return (EncoderLayer(cfg, device, par, n) if kind == "enc"
                else CrossDecoderLayer(cfg, window, device, par, n))
    norm, gqa, swiglu = _parts(cfg, device, par, n)
    if kind == "shared_attn":
        return AttnBlock(norm(), gqa())
    pw = dict(dtype=DTYPES[cfg.dtype], device=device, par=par)
    slots = () if n is None else (n,)
    if cfg.kv_lora_rank:
        attn = (MLA if n is None else StackedMLA)(mla_cfg(cfg), *slots, **pw)
    else:
        attn = gqa()
    if kind == "moe":
        ffn = (MoE if n is None else StackedMoE)(moe_cfg(cfg), *slots, **pw)
    else:
        ffn = swiglu()
    return DecoderLayer(norm(), attn, norm(), ffn, window)


def _stack_windows(cfg: ModelConfig, sp) -> Tuple[int, ...]:
    """Each layer's window: the plan's (``attn_mlp``), else the config's."""
    return tuple(sp.meta.get("window", (cfg.sliding_window,) * sp.n))


def build_stacks(cfg: ModelConfig, plan, device=None, par=None) -> List[BlockStack]:
    """The stacks of ``plan`` (``model.build_plan(cfg)``), parameters
    allocated uninitialised on ``device`` (this rank's shards under
    ``par``)."""
    return [BlockStack(sp.kind, [_layer(cfg, sp.kind, w, device, par=par)
                                 for w in _stack_windows(cfg, sp)], sp.meta)
            for sp in plan]


def build_stacked_stacks(cfg: ModelConfig, plan, n: int, device=None,
                         par=None) -> List[BlockStack]:
    """The stacks of ``plan`` with n slots a layer (zeroed parameters on
    ``device``)."""
    return [BlockStack(sp.kind, [_layer(cfg, sp.kind, w, device, n, par)
                                 for w in _stack_windows(cfg, sp)], sp.meta)
            for sp in plan]


def _layer_args(stack: BlockStack, positions: torch.Tensor, memory) -> tuple:
    if stack.kind in X_ONLY_KINDS:
        return ()
    return (positions, memory) if stack.kind == "dec_cross" else (positions,)


def run_stack(stack: BlockStack, x: torch.Tensor, positions: torch.Tensor,
              remat: bool = False, memory: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux_loss_sum): a ``moe`` stack sums its layers' router
    losses (each (n,) in a stacked model), the other kinds have none; a
    ``dec_cross`` stack reads the encoder's ``memory``.  With ``remat``
    (``cfg.remat``) each layer is checkpointed when a gradient is being
    recorded: its activations are recomputed in the backward, as the
    reference's ``jax.checkpoint`` of the scanned layer body does."""
    ckpt = remat and torch.is_grad_enabled()
    args = _layer_args(stack, positions, memory)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in stack.layers:
        y = checkpoint(layer, x, *args, use_reentrant=False) if ckpt else layer(x, *args)
        x, a = y if isinstance(y, tuple) else (y, None)
        if a is not None:
            aux = aux + a
    return x, aux


def slice_stack(stack: BlockStack, lo: int, hi: int) -> BlockStack:
    """Layers [lo, hi) of ``stack`` as a stack of their own, sharing the
    layer modules (the reference's ``_slice_meta`` of the plan plus the
    params slice)."""
    meta = {k: v[lo:hi] for k, v in stack.meta.items()}
    return BlockStack(stack.kind, list(stack.layers[lo:hi]), meta)


def _attention(stack: BlockStack) -> Optional[nn.Module]:
    """The attention of a stack's layers whose decode cache is a KV or
    latent cache (the decoder's self-attention), None for a mixer."""
    layer = stack.layers[0]
    return getattr(layer, "self_attn", getattr(layer, "attn", None))


def init_stack_cache(cfg: ModelConfig, stack: BlockStack, batch: int, max_seq: int,
                     dtype: torch.dtype, device=None, panels: Optional[Panels] = None
                     ) -> Dict[str, torch.Tensor]:
    """A stack's zeroed decode cache: the KV cache in ``dtype`` (an MLA
    stack's latent and rope key; a ``shared_attn`` block's without a layer
    axis), or the mixer kinds' recurrent state (f32, and Mamba2's
    convolution inputs in ``dtype``; independent of ``max_seq``).  A
    tensor-parallel stack's cache holds the rank's heads (the attention's
    or the mixer's own); under ``panels`` (a sequence-sharded cache) a KV
    or latent cache holds this rank's panel of ``panels.length``
    positions."""
    if panels is not None and panels.count > 1:
        max_seq = panels.length
    if stack.kind in MIXERS:
        mixer = stack.layers[0].mixer
        parts = mixer.par.model_size if stack.kind in SPLIT_MIXERS else 1
        if stack.kind == "mamba":
            return ssm.init_ssm_cache(batch, ssm_cfg(cfg), dtype, device, stack.n, parts)
        if stack.kind == "mlstm":
            return xlstm.init_mlstm_cache(batch, xlstm_cfg(cfg), device, stack.n, parts)
        return xlstm.init_slstm_cache(batch, xlstm_cfg(cfg), device, stack.n)
    attn = _attention(stack)
    if isinstance(attn, MLA):
        return init_mla_cache(stack.n, batch, max_seq, attn.cfg, dtype, device)
    cache = init_kv_cache(stack.n, batch, max_seq, attn.cfg, dtype, device)
    if stack.kind == "shared_attn":
        return {name: t[0] for name, t in cache.items()}
    return cache


def decode_stack(stack: BlockStack, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 index: int, memory: Optional[torch.Tensor] = None,
                 panels: Optional[Panels] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step through a stack.  x: (B, 1, d_model); the cache is
    written in place and returned; a ``dec_cross`` stack reads the
    encoder's ``memory``; the attention kinds' caches lie over ``panels``
    (None: the whole sequence here)."""
    if stack.kind == "shared_attn":
        return stack.layers[0].decode(x, cache, index, panels), cache
    args = (() if stack.kind in MIXERS else (index, memory, panels)
            if stack.kind == "dec_cross" else (index, panels))
    for i, layer in enumerate(stack.layers):
        x = layer.decode(x, {name: t[i] for name, t in cache.items()}, *args)
    return x, cache


__all__ = ["AttnBlock", "BlockStack", "CrossDecoderLayer", "DecoderLayer", "ENCDEC",
           "EncoderLayer", "MIXERS", "MixerBlock", "SPLIT_MIXERS", "StackedMixerBlock",
           "attn_cfg", "build_stacked_stacks", "build_stacks", "decode_stack",
           "init_stack_cache", "mla_cfg", "moe_cfg", "not_ported", "run_stack", "slice_stack",
           "ssm_cfg", "xlstm_cfg"]
