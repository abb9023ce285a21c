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

Forward, loss and the split view are differentiable: the attention runs
through B5 and its backward, the loss through B4 (``ops.
fused_cross_entropy``, forward and backward) on the card.  An xLSTM model
differentiates on the CPU only: B7 has no backward kernel yet, so its scan
raises on the card when a gradient is recorded.  ``cfg.remat`` checkpoints
each layer.  The serve path (``decode_step``, the prefill step) runs under
``torch.inference_mode()``.
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
from .blocks import DTYPES, Linear, RMSNorm, embed_init
from .config import ModelConfig

Cache = Tuple[Dict[str, torch.Tensor], ...]
Batch = Dict[str, torch.Tensor]

#: where the cluster-stacked LM (the batched engine's form of it) comes from
STACKED_LM_SLICE = ("ROADMAP.md Queue A item 10, a cluster-stacked LM (engine='batched' "
                    "over core.split.from_lm)")


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
        cut = self.cfg.cut_layer
        client, ap, slices = [], [], []
        seen = 0
        for idx, sp in enumerate(self.plan):
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

    def split_params(self) -> Tuple[ClientLM, APLM]:
        """(gamma, phi): the client's and the AP's halves, sharing this
        model's parameters (a cut stack is sliced, its layers shared)."""
        _, _, slices = self.split_plans()
        client_stacks, ap_stacks = [], []
        for (idx, take, total), stack in zip(slices, self.stacks):
            if take == total:
                client_stacks.append(stack)
            elif take == 0:
                ap_stacks.append(stack)
            else:
                client_stacks.append(tfm.slice_stack(stack, 0, take))
                ap_stacks.append(tfm.slice_stack(stack, take, total))
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


__all__ = ["APLM", "ClientLM", "Model", "STACKED_LM_SLICE", "StackPlan", "build_model",
           "build_plan"]
