"""Top-level LM: the reference's ``repro/models/model.py`` for every
architecture family (the dense family, the vlm, MoE with GQA or MLA, xLSTM,
Mamba2, the Zamba2 hybrid and the encoder-decoder), as an ``nn.Module``
that holds its parameters.

A vlm (``arch_type="vlm"``, the dense stack) takes ``batch["patches"]`` (B,
P, d_model), the stubbed vision tower's patch embeddings: they go before
the scaled token embeddings, cast to the embedding's dtype and not scaled,
rope positions run over the whole prefixed sequence, and the loss drops the
P prefix positions before the head.  Without patches it is the dense LM
(the serve loop and the LM round take tokens only, as the reference's do).
A MoE's loss adds every ``moe`` layer's router loss; the client's half drops
its own (the reference's ``client_forward``), the AP's adds its own.

An encoder-decoder (``arch_type="encdec"``/``"audio"``) takes
``batch["frames"]`` (B, F, d_model), the stubbed modality frontend's frame
embeddings: :meth:`Model.encode` runs them through :class:`Encoder`
(``n_enc_layers`` bidirectional layers and a norm: the reference's
``params["encoder"]``), and every decoder layer's cross-attention reads
that memory.  The client's half holds the encoder and sends ``[x, memory]``
concatenated along the sequence as its cut message; the AP's splits it
again at the token count.  ``decode_step`` takes the memory.

``build_model(cfg, device)`` allocates the parameters uninitialised on the
device (the card unless ``device="cpu"``); :meth:`Model.init` draws them
from a ``torch.Generator``.  The reference's pure functions over a params
pytree become methods:

  * ``init(generator)``                 — parameter initialisation, in place
  * ``forward(batch)``                  — final hidden states (B, S, D), aux
  * ``logits(batch)``                   — (B, S, V)
  * ``loss(batch)``                     — scalar LM loss (+ aux), metrics
  * ``split_params()``                  — (client gamma, AP phi) at
                                          cfg.cut_layer, as modules that
                                          share this model's parameters
  * ``merge_params(gamma, phi)``        — the model over gamma's and phi's
                                          parameters
  * ``client_forward(gamma, batch)``    — cut-layer activations (B, S, D)
  * ``ap_forward(phi, acts, batch)``    — loss from cut activations
  * ``init_cache(batch_size, max_seq, seq_shard=False)`` — zeroed decode
                                          cache (a :class:`DecodeCache`)
  * ``decode_step(cache, tokens, i)``   — one-token decode -> (logits, cache)

The batched round's form of it is :class:`StackedModel`
(``build_stacked_model(cfg, r, replicas, device)``): n = L * R slots of the
same parameters, each with a leading slot axis, split into
:class:`StackedClientLM` and :class:`StackedAPLM`, whose ``parameters()``
follow the plain halves' order.  Its entry points take n slots' batches:

  * ``client_forward(g, tokens (n, B, S))`` — cut activations (n, B, S, D)
  * ``ap_losses(p, acts, labels)``          — per-slot losses (n,) f32 (B4
                                              once a slot); labels (n, B, S),
                                              or (B, S) shared by every slot
  * ``loss(batches)``                       — per-slot LM losses (n,)

Each slot's products run on views of the stacked weights, one a slot; the
parameter-free work (the norms' arithmetic, rotary, SiLU, attention, the
mLSTM's chunked einsums) runs over all slots at once, the slot axis folded
into the batch axis; the sLSTM's scan (B7) runs once a slot, each with its
own R; MLA, the MoE and Mamba2 run a call a slot (``StackedMLA``,
``StackedMoE``, ``StackedMamba2``), so that each slot routes and drops as
its plain model does.  Every plan stacks (a vlm on tokens only; an
encoder-decoder's slots each encode their own ``frames``, for the launch
layer's round step: ``core.split.from_lm`` takes no encoder-decoder); a
MoE slot's loss carries its own router loss.

Forward, loss and the split view are differentiable: the attention runs
through B5 and its backward (non-causal for the encoder and the
cross-attention), the loss through B4 (``ops.fused_cross_entropy``, forward
and backward), the sLSTM's scan through B7 and its backward
(``ops.slstm_scan``) on the card; Mamba2's SSD is plain PyTorch.  ``cfg.remat``
checkpoints each layer.  The serve path (``decode_step``, the prefill step)
runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..kernels import ops
from . import transformer as tfm
from .blocks import DTYPES, Linear, RMSNorm, StackedLinear, StackedRMSNorm, embed_init
from .config import ModelConfig
from .attention import MLA
from .parallel import (SINGLE, Panels, Parallel, cache_panels, gather_from, mark,
                       optional, reduce_from, vocab_embed, vocab_rows)

Cache = Tuple[Dict[str, torch.Tensor], ...]
Batch = Dict[str, torch.Tensor]


class DecodeCache(tuple):
    """A model's decode caches, one a stack (a tuple), with ``panels``, the
    layout of their sequence on this rank (``parallel.Panels``; count 1:
    the whole sequence), which :meth:`Model.decode_step` and the serve step
    read with no host read on the step."""
    panels: Panels = Panels()


@dataclasses.dataclass
class StackPlan:
    kind: str
    n: int
    meta: Dict[str, Any]


def _embed_tokens(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor,
                  par: Parallel = SINGLE) -> torch.Tensor:
    """The scaled lookup; under ``par``'s model axis the vocab-parallel one
    (``table`` this rank's rows)."""
    sqrt_d = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=table.dtype,
                          device=table.device)
    return vocab_embed(table, tokens, par) * sqrt_d


def _embed(cfg: ModelConfig, table: torch.Tensor, batch: Batch,
           par: Parallel = SINGLE) -> torch.Tensor:
    """The tokens' scaled embeddings, after a vlm's patches (cast to the
    table's dtype, not scaled) when the batch holds them."""
    x = _embed_tokens(cfg, table, batch["tokens"], par)
    if cfg.arch_type == "vlm" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _text_positions(cfg: ModelConfig, h: torch.Tensor, batch: Batch) -> torch.Tensor:
    """``h`` without a vlm's patch prefix: the loss runs over text only."""
    if cfg.arch_type == "vlm" and "patches" in batch:
        return h[:, batch["patches"].shape[1]:]
    return h


def _run_stacks(cfg: ModelConfig, stacks: Sequence[tfm.BlockStack], x: torch.Tensor,
                memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stack in stacks:
        x, a = tfm.run_stack(stack, x, positions, cfg.remat, memory)
        aux = aux + a
    return x, aux


class Encoder(nn.Module):
    """The encoder-decoder's encoder, the reference's ``params["encoder"]``:
    ``stacks`` (one ``enc`` stack of ``n_enc_layers`` layers, or
    ``n_layers``) and a final ``norm``.  ``forward(frames)`` -> the memory
    (B, F, d_model) in the model's dtype, whole on every rank (each layer's
    output leaves with its all-reduce under ``par``'s model axis).  With
    ``n`` the cluster-stacked form: frames (n, B, F, d_model)."""

    def __init__(self, cfg: ModelConfig, device=None, par: Optional[Parallel] = None,
                 n: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        layers = cfg.n_enc_layers or cfg.n_layers
        self.stacks = nn.ModuleList([tfm.BlockStack(
            "enc", [tfm.EncoderLayer(cfg, device, par, n) for _ in range(layers)])])
        kw = dict(dtype=DTYPES[cfg.dtype], device=device)
        self.norm = (RMSNorm(cfg.d_model, **kw) if n is None
                     else StackedRMSNorm(n, cfg.d_model, **kw))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in self.stacks[0].layers:
            layer.reset_parameters(generator)
        self.norm.reset_parameters()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(self.norm.scale.dtype)
        positions = torch.arange(x.shape[-2], device=x.device)
        x, _ = tfm.run_stack(self.stacks[0], x, positions, self.cfg.remat)
        return self.norm(x)


def _lm_loss(head: Linear, h: torch.Tensor, aux: torch.Tensor, batch: Batch,
             par: Parallel = SINGLE) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's loss tail, both of its branches (full logits or
    chunked): the mean (or masked mean) cross-entropy through B4; under
    ``par`` the vocab-parallel B4 and the whole batch's mean
    (``ops.parallel_cross_entropy``)."""
    lm = ops.parallel_cross_entropy(h, head.w, batch["labels"], batch.get("mask"), par)
    return lm + aux, {"lm_loss": lm, "aux_loss": aux}


class ClientLM(nn.Module):
    """gamma, the client's half: the embedding and the first
    ``cfg.cut_layer`` layers (and an encoder-decoder's encoder).
    ``forward(batch)`` -> cut-layer activations (B, S, d_model), the
    split-learning "smashed data"; an encoder-decoder's are (B, S + F,
    d_model), the memory after the tokens."""

    def __init__(self, cfg: ModelConfig, embedding: nn.Parameter,
                 stacks: Sequence[tfm.BlockStack], encoder: Optional[Encoder] = None,
                 par: Parallel = SINGLE):
        super().__init__()
        self.cfg = cfg
        self.par = par
        self.embedding = embedding
        self.stacks = nn.ModuleList(stacks)
        self.encoder = encoder

    def forward(self, batch: Batch) -> torch.Tensor:
        x = _embed(self.cfg, self.embedding, batch, self.par)
        if self.encoder is None:
            return _run_stacks(self.cfg, self.stacks, x)[0]
        memory = self.encoder(batch["frames"])
        return torch.cat([_run_stacks(self.cfg, self.stacks, x, memory)[0], memory], dim=1)


class APLM(nn.Module):
    """phi, the access point's half: the remaining layers, the final norm
    and the head.  ``forward(acts, batch)`` -> (loss, metrics)."""

    def __init__(self, cfg: ModelConfig, stacks: Sequence[tfm.BlockStack],
                 final_norm: RMSNorm, head: Linear, par: Parallel = SINGLE):
        super().__init__()
        self.cfg = cfg
        self.par = par
        self.stacks = nn.ModuleList(stacks)
        self.final_norm = final_norm
        self.head = head

    def forward(self, acts: torch.Tensor, batch: Batch
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        memory = None
        if self.cfg.arch_type in tfm.ENCDEC:
            s_dec = batch["tokens"].shape[1]
            acts, memory = acts[:, :s_dec], acts[:, s_dec:]
        x, aux = _run_stacks(self.cfg, self.stacks, acts, memory)
        h = _text_positions(self.cfg, self.final_norm(x), batch)
        return _lm_loss(self.head, h, aux, batch, self.par)


def _vocab_parallel(par: Parallel, embedding: torch.Tensor, head_w: torch.Tensor) -> None:
    """The embedding's rows and the head's columns over ``model`` (the
    spec's; ``par`` the vocab's view: model axis 1 where the axis does not
    divide the vocab, both then whole on each rank)."""
    if par.model_size > 1:
        mark(embedding, -2, par.model_size, par.model_rank)
        mark(head_w, -1, par.model_size, par.model_rank)


class Model(nn.Module):
    """See the module docstring.  With ``par`` (``models.parallel``, from
    ``launch.mesh.Mesh.parallel``) the model is one rank's part of the
    tensor- and data-parallel model: the embedding's rows and the head's
    columns (vocab-parallel), the attention's heads, the FFN's columns and
    the MoE's experts over ``model`` (``launch/shardings.py`` lays the
    whole tensors out); every entry takes this data rank's rows of a batch,
    the loss is the whole batch's, and ``logits``/``decode_step`` return
    the whole vocab's logits of those rows.  A vocab the model axis does
    not divide (``vocab_par``, ``Parallel.over``) is held whole: the lookup
    ``table[tokens]``, plain B4 over the whole head, no gather of logits.
    Every kind runs at model > 1 (``transformer._layer``): GQA's and MLA's
    heads, Mamba2's and the mLSTM's heads (sectioned ``in_proj``/``up``,
    ``out_norm`` over the split width), the encoder's and the decoder's
    attention and SwiGLU; the sLSTM, and a layer whose dim the axis does not
    divide, whole on each model rank."""

    def __init__(self, cfg: ModelConfig, plan: List[StackPlan], device=None,
                 par: Optional[Parallel] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.par = par = optional(par)
        dt = DTYPES[cfg.dtype]
        self.vocab_par = vp = par.over(cfg.vocab)
        v = cfg.vocab // vp.model_size
        self.embedding = nn.Parameter(torch.empty((v, cfg.d_model), dtype=dt, device=device))
        self.stacks = nn.ModuleList(tfm.build_stacks(cfg, plan, device, par))
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.head = Linear(cfg.d_model, v, dtype=dt, device=device)
        self.encoder = Encoder(cfg, device, par) if cfg.arch_type in tfm.ENCDEC else None
        _vocab_parallel(vp, self.embedding, self.head.w)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        return self.embedding.dtype

    # -- construction -------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter as the reference's ``Model.init`` does (in f32
        on ``generator``'s device, then cast), in a fixed order; returns the
        model.  A tensor-parallel model draws the same values, one whole
        tensor or layer at a time, and keeps its shards
        (``launch.shardings.shard_params``): a layer's whole weights at
        most are on the device beside its own."""
        cfg = self.cfg
        if self.par.model_size > 1:
            return self._init_shards(generator)
        self.embedding.copy_(embed_init(generator, cfg.vocab, cfg.d_model))
        for stack in self.stacks:
            for layer in stack.layers:
                layer.reset_parameters(generator)
        self.final_norm.reset_parameters()
        self.head.w.copy_(embed_init(generator, cfg.d_model, cfg.vocab))
        if self.encoder is not None:
            self.encoder.reset_parameters(generator)
        return self

    @torch.no_grad()
    def _init_shards(self, generator: torch.Generator) -> "Model":
        """:meth:`init`'s draws in its order, each kept as this rank's
        shard."""
        from ..launch.shardings import shard_param, shard_params
        cfg = self.cfg
        shard_param(self.embedding, embed_init(generator, cfg.vocab, cfg.d_model))
        for stack, sp in zip(self.stacks, self.plan):
            for layer, window in zip(stack.layers, tfm._stack_windows(cfg, sp)):
                whole = tfm._layer(cfg, sp.kind, window, self.device)
                whole.reset_parameters(generator)
                shard_params(layer, dict(whole.named_parameters()))
                del whole
        self.final_norm.reset_parameters()
        shard_param(self.head.w, embed_init(generator, cfg.d_model, cfg.vocab))
        if self.encoder is not None:
            for layer in self.encoder.stacks[0].layers:
                whole = tfm.EncoderLayer(cfg, self.device)
                whole.reset_parameters(generator)
                shard_params(layer, dict(whole.named_parameters()))
                del whole
            self.encoder.norm.reset_parameters()
        return self

    # -- embedding ----------------------------------------------------------
    def embed(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, positions); a vlm's patches lead x."""
        x = _embed(self.cfg, self.embedding, batch, self.vocab_par)
        return x, torch.arange(x.shape[1], device=x.device)

    def encode(self, batch: Batch) -> torch.Tensor:
        """An encoder-decoder's encoder pass over ``batch["frames"]`` (B, F,
        d_model), the precomputed frame embeddings: the memory (B, F,
        d_model), each layer checkpointed under ``cfg.remat``."""
        return self.encoder(batch["frames"])

    # -- forward / loss -------------------------------------------------------
    def forward(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward to final hidden states.  Returns (hidden, aux)."""
        memory = self.encode(batch) if self.encoder is not None else None
        x, aux = _run_stacks(self.cfg, self.stacks, self.embed(batch)[0], memory)
        return self.final_norm(x), aux

    def logits(self, batch: Batch) -> torch.Tensor:
        h, _ = self.forward(batch)
        return self.head_logits(h)

    def head_logits(self, h: torch.Tensor) -> torch.Tensor:
        """``h @ head.w``: the whole vocab's logits (under a model axis the
        ranks' panels all-gathered)."""
        return gather_from(self.head(h), self.vocab_par.model_group, self.vocab_par.model_size)

    def loss(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"lm_loss", "aux_loss"}) of ``batch`` {"tokens", "labels",
        optional "mask", a vlm's optional "patches"}; the cross-entropy
        through B4, over the text positions."""
        h, aux = self.forward(batch)
        return _lm_loss(self.head, _text_positions(self.cfg, h, batch), aux, batch,
                        self.vocab_par)

    # -- split-learning view ------------------------------------------------
    def split_plans(self) -> Tuple[List[StackPlan], List[StackPlan], List[Tuple[int, int, int]]]:
        """Split the plan at cfg.cut_layer blocks.  Returns (client_plan,
        ap_plan, slices) where slices[i] = (stack_idx, client_n, total_n)."""
        return split_plans(self.cfg, self.plan)

    def split_params(self) -> Tuple[ClientLM, APLM]:
        """(gamma, phi): the client's and the AP's halves, sharing this
        model's parameters (a cut stack is sliced, its layers shared)."""
        client_stacks, ap_stacks = _split_stacks(self.cfg, self.plan, self.stacks)
        return (ClientLM(self.cfg, self.embedding, client_stacks, self.encoder, self.vocab_par),
                APLM(self.cfg, ap_stacks, self.final_norm, self.head, self.vocab_par))

    def merge_params(self, gamma: ClientLM, phi: APLM) -> "Model":
        """The model whose parameters are gamma's and phi's (shared, not
        copied)."""
        _, _, slices = self.split_plans()
        stacks, ci, ai = [], 0, 0
        for idx, take, total in slices:
            if take == total:
                stacks.append(gamma.stacks[ci]); ci += 1
            elif take == 0:
                stacks.append(phi.stacks[ai]); ai += 1
            else:
                c, a = gamma.stacks[ci], phi.stacks[ai]
                meta = {k: tuple(c.meta[k]) + tuple(a.meta[k]) for k in c.meta}
                stacks.append(tfm.BlockStack(c.kind, [*c.layers, *a.layers], meta))
                ci += 1; ai += 1
        model = Model(self.cfg, self.plan, "meta", self.par)  # a shell: nothing allocated
        model.embedding = gamma.embedding
        model.stacks = nn.ModuleList(stacks)
        model.final_norm = phi.final_norm
        model.head = phi.head
        model.encoder = gamma.encoder
        return model

    def client_forward(self, gamma: ClientLM, batch: Batch) -> torch.Tensor:
        """Client-side NN g(x, gamma): embedding + first cut_layer blocks ->
        cut-layer activations (B, S, d_model); an encoder-decoder's with the
        memory after them, (B, S + F, d_model)."""
        return gamma(batch)

    def ap_forward(self, phi: APLM, acts: torch.Tensor, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """AP-side NN h(a, phi): remaining blocks + head -> (loss, metrics),
        the cross-entropy through B4; an encoder-decoder's ``acts`` are split
        at ``batch["tokens"]``'s length into x and the memory."""
        return phi(acts, batch)

    # -- decode -----------------------------------------------------------------
    def kv_share(self) -> int:
        """How many model ranks hold this rank's KV heads: 1, m / Hkv where
        they share a KV head, m where the attention block is whole or, for
        MLA, always (its latent cache has no head axis); those ranks split
        the decode cache's sequence.  1 for a model with no KV cache."""
        for stack in self.stacks:
            attn = tfm._attention(stack)
            if isinstance(attn, MLA):
                return self.par.model_size
            if attn is not None:
                return attn.heads.share
        return 1

    def init_cache(self, batch_size: int, max_seq: int, seq_shard: bool = False
                   ) -> DecodeCache:
        """Zeroed decode caches, one per stack: KV caches in the model's
        dtype, the mixer kinds' recurrent state in f32 (Mamba2's
        convolution inputs in the model's dtype).  A parallel model's
        holds this data rank's rows of ``batch_size`` (the whole batch's)
        and its KV heads; where several ranks hold the same KV heads, this
        rank's panel of their sequence (``parallel.cache_panels``): the
        model ranks that share them, and with ``seq_shard`` (or a batch of
        1, the reference's ``input_specs``) the data ranks too, each of
        which then holds every row.  The layout rides on the cache
        (``DecodeCache.panels``)."""
        par = self.par
        panels = cache_panels(par, self.kv_share(), max_seq, seq_shard or batch_size == 1)
        rows = batch_size
        if par.data_size > 1 and not panels.rows_whole:
            rows = par.local_rows(torch.empty((batch_size, 0), device="meta")).shape[0]
        cache = DecodeCache(tfm.init_stack_cache(self.cfg, stack, rows, max_seq, self.dtype,
                                                 self.device, panels)
                            for stack in self.stacks)
        cache.panels = panels
        return cache

    @torch.inference_mode()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, index: int,
                    memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) int; index: the tokens' position (host int); an
        encoder-decoder's ``memory`` (B, F, d_model), which its
        cross-attention reads.  Writes the cache in place; returns (logits
        (B, 1, V), cache).  The cache's sequence layout is its ``panels``
        (:meth:`init_cache`)."""
        panels = getattr(cache, "panels", None)
        if panels is None and self.kv_share() > 1:
            raise ValueError("this rank's KV heads are shared: decode on a cache from "
                             "init_cache, which carries its sequence panels")
        x = _embed_tokens(self.cfg, self.embedding, tokens, self.vocab_par)
        for stack, c in zip(self.stacks, cache):
            x, _ = tfm.decode_stack(stack, x, c, index, memory, panels)
        return self.head_logits(self.final_norm(x)), cache


def _slice_meta(meta: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    return {k: v[lo:hi] for k, v in meta.items()}


def split_plans(cfg: ModelConfig, plan: Sequence[StackPlan]
                ) -> Tuple[List[StackPlan], List[StackPlan], List[Tuple[int, int, int]]]:
    """:meth:`Model.split_plans` of ``(cfg, plan)``."""
    cut = cfg.cut_layer
    client, ap, slices = [], [], []
    seen = 0
    for idx, sp in enumerate(plan):
        take = max(0, min(sp.n, cut - seen))
        if take == sp.n:
            client.append(sp)
        elif take == 0:
            ap.append(sp)
        else:
            client.append(StackPlan(sp.kind, take, _slice_meta(sp.meta, 0, take)))
            ap.append(StackPlan(sp.kind, sp.n - take, _slice_meta(sp.meta, take, sp.n)))
        slices.append((idx, take, sp.n))
        seen += sp.n
    return client, ap, slices


def _split_stacks(cfg: ModelConfig, plan: Sequence[StackPlan],
                  stacks: Sequence[tfm.BlockStack]
                  ) -> Tuple[List[tfm.BlockStack], List[tfm.BlockStack]]:
    """A model's stacks cut at cfg.cut_layer: (client stacks, AP stacks),
    sharing the layers."""
    client_stacks, ap_stacks = [], []
    for (_, take, total), stack in zip(split_plans(cfg, plan)[2], stacks):
        if take == total:
            client_stacks.append(stack)
        elif take == 0:
            ap_stacks.append(stack)
        else:
            client_stacks.append(tfm.slice_stack(stack, 0, take))
            ap_stacks.append(tfm.slice_stack(stack, take, total))
    return client_stacks, ap_stacks


# ---------------------------------------------------------------------------
# the cluster-stacked LM (the batched round's form)
# ---------------------------------------------------------------------------

def _run_stacked(cfg: ModelConfig, stacks: Sequence[tfm.BlockStack], x: torch.Tensor,
                 memory: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_run_stacks` over n slots' activations (n, B, S, D) (and an
    encoder-decoder's memories (n, B, F, D)); the aux is a scalar 0, or
    (n,) where a ``moe`` stack ran."""
    positions = torch.arange(x.shape[2], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stack in stacks:
        x, a = tfm.run_stack(stack, x, positions, cfg.remat, memory)
        aux = aux + a
    return x, aux


def _slot_losses(head: StackedLinear, h: torch.Tensor, aux: torch.Tensor,
                 labels: torch.Tensor, mask=None, par: Parallel = SINGLE) -> torch.Tensor:
    """Each slot's :func:`_lm_loss` (B4 once a slot, each with its own
    head): (n,) f32.  ``labels`` (and ``mask``) are (n, B, S), or (B, S)
    shared by every slot."""
    labels = labels.expand(h.shape[:-1])
    masks = [None] * h.shape[0] if mask is None else mask.expand(h.shape[:-1])
    return torch.stack([ops.parallel_cross_entropy(hi, wi, li, mi, par) + ai
                        for hi, wi, li, mi, ai in zip(h, head.w, labels, masks,
                                                      aux.expand(h.shape[0]))])


def _embed_slots(cfg: ModelConfig, tables: torch.Tensor, tokens: torch.Tensor,
                 par: Parallel = SINGLE) -> torch.Tensor:
    """:func:`_embed_tokens` a slot: the lookup in each slot's own table
    (and its gradient into that table alone), the scale over all slots;
    under a model axis each slot's masked lookup in its rows, then one
    all-reduce for all slots."""
    x = torch.stack([vocab_rows(table, t, par) for table, t in zip(tables, tokens)])
    x = reduce_from(x, par.model_group, par.model_size)
    return x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=x.dtype, device=x.device)


class StackedClientLM(nn.Module):
    """n slots' gamma: embedding (n, V, D) and the first ``cfg.cut_layer``
    stacked layers.  ``forward(tokens (n, B, S))`` -> (n, B, S, D)."""

    def __init__(self, cfg: ModelConfig, embedding: nn.Parameter,
                 stacks: Sequence[tfm.BlockStack], par: Parallel = SINGLE):
        super().__init__()
        self.cfg = cfg
        self.par = par
        self.embedding = embedding
        self.stacks = nn.ModuleList(stacks)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return _run_stacked(self.cfg, self.stacks,
                            _embed_slots(self.cfg, self.embedding, tokens, self.par))[0]


class StackedAPLM(nn.Module):
    """n slots' phi: the remaining stacked layers, the final norm and the
    head.  ``forward(acts (n, B, S, D), labels, mask=None)`` -> per-slot
    losses (n,) f32."""

    def __init__(self, cfg: ModelConfig, stacks: Sequence[tfm.BlockStack],
                 final_norm: StackedRMSNorm, head: StackedLinear, par: Parallel = SINGLE):
        super().__init__()
        self.cfg = cfg
        self.par = par
        self.stacks = nn.ModuleList(stacks)
        self.final_norm = final_norm
        self.head = head

    def forward(self, acts: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
        x, aux = _run_stacked(self.cfg, self.stacks, acts)
        return _slot_losses(self.head, self.final_norm(x), aux, labels, mask, self.par)


class StackedModel(nn.Module):
    """n slots of one :class:`Model`, of any family (see the module
    docstring): ``parameters()`` follow :class:`Model`'s
    order with a leading slot axis each.  Built zeroed on ``device`` (None: the current
    default device); :meth:`load_slot` writes a plain model into a slot.  With
    ``par`` each slot is one rank's part of the parallel model, as
    :class:`Model`'s (a slot's plain model then has the same ``par``)."""

    def __init__(self, cfg: ModelConfig, plan: List[StackPlan], n: int, device=None,
                 par: Optional[Parallel] = None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.n = n
        self.par = par = optional(par)
        dt = DTYPES[cfg.dtype]
        self.vocab_par = vp = par.over(cfg.vocab)
        v = cfg.vocab // vp.model_size
        self.embedding = nn.Parameter(torch.zeros((n, v, cfg.d_model), dtype=dt,
                                                  device=device))
        self.stacks = nn.ModuleList(tfm.build_stacked_stacks(cfg, plan, n, device, par))
        self.final_norm = StackedRMSNorm(n, cfg.d_model, dtype=dt, device=device)
        self.head = StackedLinear(n, cfg.d_model, v, dtype=dt, device=device)
        self.encoder = Encoder(cfg, device, par, n) if cfg.arch_type in tfm.ENCDEC else None
        _vocab_parallel(vp, self.embedding, self.head.w)

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    @torch.no_grad()
    def load_slot(self, r: int, model: Model) -> "StackedModel":
        """Write ``model``'s parameters into slot ``r``; returns self."""
        for big, p in zip(self.parameters(), model.parameters()):
            big[r].copy_(p)
        return self

    @torch.no_grad()
    def slot_model(self, r: int) -> Model:
        """Slot ``r`` as a plain :class:`Model` (a copy, on this device)."""
        model = Model(self.cfg, self.plan, self.device, self.par)
        for p, big in zip(model.parameters(), self.parameters()):
            p.copy_(big[r])
        return model

    def split_params(self) -> Tuple[StackedClientLM, StackedAPLM]:
        """(gamma, phi) over all n slots, sharing this model's parameters;
        an encoder-decoder's slots are not split (``core.split.from_lm``
        takes none: its cut message carries the memory)."""
        if self.encoder is not None:
            raise ValueError("a stacked encoder-decoder trains whole (its round step, "
                             "quant=None): from_lm takes no encoder-decoder to split")
        client_stacks, ap_stacks = _split_stacks(self.cfg, self.plan, self.stacks)
        return (StackedClientLM(self.cfg, self.embedding, client_stacks, self.vocab_par),
                StackedAPLM(self.cfg, ap_stacks, self.final_norm, self.head, self.vocab_par))

    def client_forward(self, gamma: StackedClientLM, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (n, B, S) -> cut activations (n, B, S, D)."""
        return gamma(tokens)

    def ap_losses(self, phi: StackedAPLM, acts: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
        """Per-slot losses (n,) f32 from cut activations (n, B, S, D);
        ``labels`` (n, B, S), or (B, S) shared by every slot."""
        return phi(acts, labels, mask)

    def forward(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (n, B, S) (an encoder-decoder's frames (n, B, F, D)) ->
        (final hidden states (n, B, S, D), aux: 0, or (n,) for a MoE)."""
        memory = None if self.encoder is None else self.encoder(frames)
        x, aux = _run_stacked(self.cfg, self.stacks,
                              _embed_slots(self.cfg, self.embedding, tokens, self.vocab_par),
                              memory)
        return self.final_norm(x), aux

    def loss(self, batches: Batch) -> torch.Tensor:
        """Per-slot LM losses (n,) f32 of ``batches`` {"tokens", "labels"
        (n, B, S), optional "mask", an encoder-decoder's "frames"}; "labels"
        and "mask" may be (B, S), shared by every slot."""
        h, aux = self.forward(batches["tokens"], batches.get("frames"))
        return _slot_losses(self.head, h, aux, batches["labels"], batches.get("mask"),
                            self.vocab_par)


def _mesh_par(mesh, cluster_axis: Optional[str] = None) -> Optional[Parallel]:
    return None if mesh is None else mesh.parallel(cluster_axis)


def build_stacked_model(cfg: ModelConfig, r: int, replicas: int = 1,
                        device: DeviceLike = None, mesh=None) -> StackedModel:
    """A zeroed :class:`StackedModel` of ``replicas * r`` slots (the replica
    form's L * R, replica-major) on ``device`` (the card unless
    ``device="cpu"``); with ``mesh`` (``launch.mesh.Mesh``) this rank's
    part of the parallel model over its data and model axes."""
    return StackedModel(cfg, build_plan(cfg), replicas * r, resolve_device(device),
                        _mesh_par(mesh, "pod"))


def build_plan(cfg: ModelConfig) -> List[StackPlan]:
    """Static stack layout, which ``tfm.build_stacks`` builds: one
    ``attn_mlp`` stack with each layer's sliding window (0 = global) for
    the dense family and the vlm; for a MoE, ``first_dense`` layers of the
    ``dense_mlp`` kind, then the ``moe`` kind; for xLSTM, ``slstm_every -
    1`` mLSTM blocks then one sLSTM block, repeated over ``n_layers``; for
    Mamba2 (``ssm`` without ``slstm_every``) one ``mamba`` stack; for the
    hybrid, ``attn_every`` Mamba2 layers then one ``shared_attn`` block,
    repeated over ``n_layers`` Mamba2 layers (no block after the last);
    for the encoder-decoder one ``dec_cross`` stack (the encoder is
    :class:`Encoder`, outside the plan)."""
    at = cfg.arch_type
    if at in ("dense", "vlm"):
        return [StackPlan("attn_mlp", cfg.n_layers, {"window": tfm._layer_windows(cfg)})]
    if at == "moe":
        plan = [StackPlan("dense_mlp", cfg.first_dense, {})] if cfg.first_dense else []
        return plan + [StackPlan("moe", cfg.n_layers - cfg.first_dense, {})]
    if at in tfm.ENCDEC:
        return [StackPlan("dec_cross", cfg.n_layers, {})]
    if at == "ssm" and not cfg.slstm_every:
        return [StackPlan("mamba", cfg.n_layers, {})]
    if at == "hybrid":
        period = cfg.attn_every or cfg.n_layers
        plan: List[StackPlan] = []
        remaining = cfg.n_layers
        while remaining > 0:
            n_m = min(period, remaining)
            plan.append(StackPlan("mamba", n_m, {}))
            remaining -= n_m
            if remaining > 0:
                plan.append(StackPlan("shared_attn", 1, {}))
        return plan
    if at != "ssm":
        raise tfm.not_ported(at)
    plan = []
    remaining = cfg.n_layers
    while remaining > 0:
        n_m = min(cfg.slstm_every - 1, remaining)
        if n_m > 0:
            plan.append(StackPlan("mlstm", n_m, {}))
            remaining -= n_m
        if remaining > 0:
            plan.append(StackPlan("slstm", 1, {}))
            remaining -= 1
    return plan


def build_model(cfg: ModelConfig, device: DeviceLike = None, mesh=None) -> Model:
    """The model of ``cfg`` with uninitialised parameters on ``device`` (the
    card unless ``device="cpu"``); call :meth:`Model.init` to draw them.
    With ``mesh`` (``launch.mesh.Mesh``) this rank's part of the parallel
    model over the mesh's data and model axes."""
    plan = build_plan(cfg)
    return Model(cfg, plan, resolve_device(device), _mesh_par(mesh))


__all__ = ["APLM", "ClientLM", "DecodeCache", "Encoder", "Model", "StackPlan", "StackedAPLM",
           "StackedClientLM", "StackedModel", "build_model", "build_plan",
           "build_stacked_model", "split_plans"]
