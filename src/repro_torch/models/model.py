"""Top-level LM: the reference's ``repro/models/model.py`` for the dense
family and xLSTM, as an ``nn.Module`` that holds its parameters.

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
  * ``init_cache(batch_size, max_seq)`` — zeroed decode cache
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
own R.  Dense and xLSTM plans both stack.

Forward, loss and the split view are differentiable: the attention runs
through B5 and its backward, the loss through B4 (``ops.
fused_cross_entropy``, forward and backward), the sLSTM's scan through B7
and its backward (``ops.slstm_scan``) on the card.  ``cfg.remat``
checkpoints each layer.  The serve path (``decode_step``, the prefill step)
runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from ..kernels import ops
from . import transformer as tfm
from .blocks import DTYPES, Linear, RMSNorm, StackedLinear, StackedRMSNorm, embed_init
from .config import ModelConfig

Cache = Tuple[Dict[str, torch.Tensor], ...]
Batch = Dict[str, torch.Tensor]

@dataclasses.dataclass
class StackPlan:
    kind: str
    n: int
    meta: Dict[str, Any]


def _embed_tokens(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    sqrt_d = torch.tensor(math.sqrt(float(cfg.d_model)), dtype=table.dtype,
                          device=table.device)
    return table[tokens] * sqrt_d


def _run_stacks(cfg: ModelConfig, stacks: Sequence[tfm.BlockStack], x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stack in stacks:
        x, a = tfm.run_stack(stack, x, positions, cfg.remat)
        aux = aux + a
    return x, aux


def _lm_loss(head: Linear, h: torch.Tensor, aux: torch.Tensor, batch: Batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's loss tail, both of its branches (full logits or
    chunked): the mean (or masked mean) cross-entropy through B4."""
    lm = ops.fused_cross_entropy(h, head.w, batch["labels"], batch.get("mask"))
    return lm + aux, {"lm_loss": lm, "aux_loss": aux}


class ClientLM(nn.Module):
    """gamma, the client's half: the embedding and the first
    ``cfg.cut_layer`` layers.  ``forward(batch)`` -> cut-layer activations
    (B, S, d_model), the split-learning "smashed data"."""

    def __init__(self, cfg: ModelConfig, embedding: nn.Parameter,
                 stacks: Sequence[tfm.BlockStack]):
        super().__init__()
        self.cfg = cfg
        self.embedding = embedding
        self.stacks = nn.ModuleList(stacks)

    def forward(self, batch: Batch) -> torch.Tensor:
        x = _embed_tokens(self.cfg, self.embedding, batch["tokens"])
        return _run_stacks(self.cfg, self.stacks, x)[0]


class APLM(nn.Module):
    """phi, the access point's half: the remaining layers, the final norm
    and the head.  ``forward(acts, batch)`` -> (loss, metrics)."""

    def __init__(self, cfg: ModelConfig, stacks: Sequence[tfm.BlockStack],
                 final_norm: RMSNorm, head: Linear):
        super().__init__()
        self.cfg = cfg
        self.stacks = nn.ModuleList(stacks)
        self.final_norm = final_norm
        self.head = head

    def forward(self, acts: torch.Tensor, batch: Batch
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x, aux = _run_stacks(self.cfg, self.stacks, acts)
        return _lm_loss(self.head, self.final_norm(x), aux, batch)


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, plan: List[StackPlan], device=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        dt = DTYPES[cfg.dtype]
        self.embedding = nn.Parameter(torch.empty((cfg.vocab, cfg.d_model), dtype=dt,
                                                  device=device))
        self.stacks = nn.ModuleList(tfm.build_stacks(cfg, plan, device))
        self.final_norm = RMSNorm(cfg.d_model, dtype=dt, device=device)
        self.head = Linear(cfg.d_model, cfg.vocab, dtype=dt, device=device)

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
        model."""
        cfg = self.cfg
        self.embedding.copy_(embed_init(generator, cfg.vocab, cfg.d_model))
        for stack in self.stacks:
            for layer in stack.layers:
                layer.reset_parameters(generator)
        self.final_norm.reset_parameters()
        self.head.w.copy_(embed_init(generator, cfg.d_model, cfg.vocab))
        return self

    # -- embedding ----------------------------------------------------------
    def embed(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, positions)."""
        x = _embed_tokens(self.cfg, self.embedding, batch["tokens"])
        return x, torch.arange(x.shape[1], device=x.device)

    # -- forward / loss -------------------------------------------------------
    def forward(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward to final hidden states.  Returns (hidden, aux)."""
        x, aux = _run_stacks(self.cfg, self.stacks, self.embed(batch)[0])
        return self.final_norm(x), aux

    def logits(self, batch: Batch) -> torch.Tensor:
        h, _ = self.forward(batch)
        return self.head(h)

    def loss(self, batch: Batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {"lm_loss", "aux_loss"}) of ``batch`` {"tokens", "labels",
        optional "mask"}; the cross-entropy through B4."""
        h, aux = self.forward(batch)
        return _lm_loss(self.head, h, aux, batch)

    # -- split-learning view ------------------------------------------------
    def split_plans(self) -> Tuple[List[StackPlan], List[StackPlan], List[Tuple[int, int, int]]]:
        """Split the plan at cfg.cut_layer blocks.  Returns (client_plan,
        ap_plan, slices) where slices[i] = (stack_idx, client_n, total_n)."""
        return split_plans(self.cfg, self.plan)

    def split_params(self) -> Tuple[ClientLM, APLM]:
        """(gamma, phi): the client's and the AP's halves, sharing this
        model's parameters (a cut stack is sliced, its layers shared)."""
        client_stacks, ap_stacks = _split_stacks(self.cfg, self.plan, self.stacks)
        return (ClientLM(self.cfg, self.embedding, client_stacks),
                APLM(self.cfg, ap_stacks, self.final_norm, self.head))

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
        model = Model(self.cfg, self.plan, device="meta")    # a shell: nothing allocated
        model.embedding = gamma.embedding
        model.stacks = nn.ModuleList(stacks)
        model.final_norm = phi.final_norm
        model.head = phi.head
        return model

    def client_forward(self, gamma: ClientLM, batch: Batch) -> torch.Tensor:
        """Client-side NN g(x, gamma): embedding + first cut_layer blocks ->
        cut-layer activations (B, S, d_model)."""
        return gamma(batch)

    def ap_forward(self, phi: APLM, acts: torch.Tensor, batch: Batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """AP-side NN h(a, phi): remaining blocks + head -> (loss, metrics),
        the cross-entropy through B4."""
        return phi(acts, batch)

    # -- decode -----------------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int) -> Cache:
        """Zeroed decode caches, one per stack: KV caches in the model's
        dtype, the xLSTM kinds' recurrent state in f32."""
        return tuple(tfm.init_stack_cache(self.cfg, stack, batch_size, max_seq, self.dtype,
                                          self.device)
                     for stack in self.stacks)

    @torch.inference_mode()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, index: int
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) int; index: the tokens' position (host int).
        Writes the cache in place; returns (logits (B, 1, V), cache)."""
        x = _embed_tokens(self.cfg, self.embedding, tokens)
        for stack, c in zip(self.stacks, cache):
            x, _ = tfm.decode_stack(stack, x, c, index)
        return self.head(self.final_norm(x)), cache


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

def _run_stacked(cfg: ModelConfig, stacks: Sequence[tfm.BlockStack], x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_run_stacks` over n slots' activations (n, B, S, D)."""
    positions = torch.arange(x.shape[2], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stack in stacks:
        x, a = tfm.run_stack(stack, x, positions, cfg.remat)
        aux = aux + a
    return x, aux


def _slot_losses(head: StackedLinear, h: torch.Tensor, aux: torch.Tensor,
                 labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Each slot's :func:`_lm_loss` (B4 once a slot, each with its own
    head): (n,) f32.  ``labels`` (and ``mask``) are (n, B, S), or (B, S)
    shared by every slot."""
    labels = labels.expand(h.shape[:-1])
    masks = [None] * h.shape[0] if mask is None else mask.expand(h.shape[:-1])
    return torch.stack([ops.fused_cross_entropy(hi, wi, li, mi) + aux
                        for hi, wi, li, mi in zip(h, head.w, labels, masks)])


def _embed_slots(cfg: ModelConfig, tables: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """:func:`_embed_tokens` a slot: the lookup in each slot's own table
    (and its gradient into that table alone), the scale over all slots."""
    x = torch.stack([table[t] for table, t in zip(tables, tokens)])
    return x * torch.tensor(math.sqrt(float(cfg.d_model)), dtype=x.dtype, device=x.device)


class StackedClientLM(nn.Module):
    """n slots' gamma: embedding (n, V, D) and the first ``cfg.cut_layer``
    stacked layers.  ``forward(tokens (n, B, S))`` -> (n, B, S, D)."""

    def __init__(self, cfg: ModelConfig, embedding: nn.Parameter,
                 stacks: Sequence[tfm.BlockStack]):
        super().__init__()
        self.cfg = cfg
        self.embedding = embedding
        self.stacks = nn.ModuleList(stacks)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return _run_stacked(self.cfg, self.stacks,
                            _embed_slots(self.cfg, self.embedding, tokens))[0]


class StackedAPLM(nn.Module):
    """n slots' phi: the remaining stacked layers, the final norm and the
    head.  ``forward(acts (n, B, S, D), labels, mask=None)`` -> per-slot
    losses (n,) f32."""

    def __init__(self, cfg: ModelConfig, stacks: Sequence[tfm.BlockStack],
                 final_norm: StackedRMSNorm, head: StackedLinear):
        super().__init__()
        self.cfg = cfg
        self.stacks = nn.ModuleList(stacks)
        self.final_norm = final_norm
        self.head = head

    def forward(self, acts: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
        x, aux = _run_stacked(self.cfg, self.stacks, acts)
        return _slot_losses(self.head, self.final_norm(x), aux, labels, mask)


class StackedModel(nn.Module):
    """n slots of one :class:`Model`, dense or xLSTM (see the module
    docstring): ``parameters()`` follow :class:`Model`'s order with a
    leading slot axis each.  Built zeroed on ``device`` (None: the current
    default device); :meth:`load_slot` writes a plain model into a slot."""

    def __init__(self, cfg: ModelConfig, plan: List[StackPlan], n: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.plan = plan
        self.n = n
        dt = DTYPES[cfg.dtype]
        self.embedding = nn.Parameter(torch.zeros((n, cfg.vocab, cfg.d_model), dtype=dt,
                                                  device=device))
        self.stacks = nn.ModuleList(tfm.build_stacked_stacks(cfg, plan, n, device))
        self.final_norm = StackedRMSNorm(n, cfg.d_model, dtype=dt, device=device)
        self.head = StackedLinear(n, cfg.d_model, cfg.vocab, dtype=dt, device=device)

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
        model = Model(self.cfg, self.plan, self.device)
        for p, big in zip(model.parameters(), self.parameters()):
            p.copy_(big[r])
        return model

    def split_params(self) -> Tuple[StackedClientLM, StackedAPLM]:
        """(gamma, phi) over all n slots, sharing this model's parameters."""
        client_stacks, ap_stacks = _split_stacks(self.cfg, self.plan, self.stacks)
        return (StackedClientLM(self.cfg, self.embedding, client_stacks),
                StackedAPLM(self.cfg, ap_stacks, self.final_norm, self.head))

    def client_forward(self, gamma: StackedClientLM, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (n, B, S) -> cut activations (n, B, S, D)."""
        return gamma(tokens)

    def ap_losses(self, phi: StackedAPLM, acts: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
        """Per-slot losses (n,) f32 from cut activations (n, B, S, D);
        ``labels`` (n, B, S), or (B, S) shared by every slot."""
        return phi(acts, labels, mask)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (n, B, S) -> (final hidden states (n, B, S, D), aux)."""
        x, aux = _run_stacked(self.cfg, self.stacks,
                              _embed_slots(self.cfg, self.embedding, tokens))
        return self.final_norm(x), aux

    def loss(self, batches: Batch) -> torch.Tensor:
        """Per-slot LM losses (n,) f32 of ``batches`` {"tokens", "labels"
        (n, B, S), optional "mask"}; "labels" and "mask" may be (B, S),
        shared by every slot."""
        h, aux = self.forward(batches["tokens"])
        return _slot_losses(self.head, h, aux, batches["labels"], batches.get("mask"))


def build_stacked_model(cfg: ModelConfig, r: int, replicas: int = 1,
                        device: DeviceLike = None) -> StackedModel:
    """A zeroed :class:`StackedModel` of ``replicas * r`` slots (the replica
    form's L * R, replica-major) on ``device`` (the card unless
    ``device="cpu"``)."""
    return StackedModel(cfg, build_plan(cfg), replicas * r, resolve_device(device))


def build_plan(cfg: ModelConfig) -> List[StackPlan]:
    """Static stack layout, which ``tfm.build_stacks`` builds: one
    ``attn_mlp`` stack with each layer's sliding window (0 = global) for
    the dense family; for xLSTM, ``slstm_every - 1`` mLSTM blocks then one
    sLSTM block, repeated over ``n_layers``."""
    if cfg.arch_type == "dense":
        return [StackPlan("attn_mlp", cfg.n_layers, {"window": tfm._layer_windows(cfg)})]
    if cfg.arch_type != "ssm" or not cfg.slstm_every:
        raise tfm.not_ported(cfg.arch_type)
    plan: List[StackPlan] = []
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


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model of ``cfg`` with uninitialised parameters on ``device`` (the
    card unless ``device="cpu"``); call :meth:`Model.init` to draw them."""
    plan = build_plan(cfg)
    return Model(cfg, plan, resolve_device(device))


__all__ = ["APLM", "ClientLM", "Model", "StackPlan", "StackedAPLM",
           "StackedClientLM", "StackedModel", "build_model", "build_plan",
           "build_stacked_model", "split_plans"]
