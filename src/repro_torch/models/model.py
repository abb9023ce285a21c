"""Top-level LM: the reference's ``repro/models/model.py`` for the dense
family, as an ``nn.Module`` that holds its parameters.

``build_model(cfg, device)`` allocates the parameters uninitialised on the
device (the card unless ``device="cpu"``); :meth:`Model.init` draws them
from a ``torch.Generator``.  The reference's pure functions over a params
pytree become methods:

  * ``init(generator)``                 — parameter initialisation, in place
  * ``forward(batch)``                  — final hidden states (B, S, D), aux
  * ``logits(batch)``                   — (B, S, V)
  * ``init_cache(batch_size, max_seq)`` — zeroed decode cache
  * ``decode_step(cache, tokens, i)``   — one-token decode -> (logits, cache)

Forward and decode run under ``torch.inference_mode()``: the attention
kernels have no backward yet.  ``loss`` and the split-learning view
(``split_params``, ``client_forward``, ``ap_forward``) come with the
training slice and raise until then.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from .. import DeviceLike, resolve_device
from . import transformer as tfm
from .blocks import DTYPES, Linear, RMSNorm, embed_init
from .config import ModelConfig

Cache = Tuple[Dict[str, torch.Tensor], ...]

_TRAINING = ("ROADMAP.md Queue A item 10, the training slice (Model.loss with B4 "
             "fused_xent and its backward, core/split.py::from_lm)")


@dataclasses.dataclass
class StackPlan:
    kind: str
    n: int
    meta: Dict[str, Any]


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, plan: List[StackPlan], device=None):
        super().__init__()
        self.cfg = cfg
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
    def embed(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (x, positions)."""
        x = self._embed_tokens(batch["tokens"])
        return x, torch.arange(x.shape[1], device=x.device)

    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        sqrt_d = torch.tensor(math.sqrt(float(self.cfg.d_model)), dtype=self.dtype,
                              device=self.device)
        return self.embedding[tokens] * sqrt_d

    # -- forward --------------------------------------------------------------
    @torch.inference_mode()
    def forward(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward to final hidden states.  Returns (hidden, aux)."""
        x, positions = self.embed(batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for stack in self.stacks:
            x, a = tfm.run_stack(stack, x, positions)
            aux = aux + a
        return self.final_norm(x), aux

    @torch.inference_mode()
    def logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        h, _ = self.forward(batch)
        return self.head(h)

    def loss(self, batch):
        raise NotImplementedError(f"Model.loss: {_TRAINING}")

    def split_params(self):
        raise NotImplementedError(f"Model.split_params: {_TRAINING}")

    def client_forward(self, gamma, batch):
        raise NotImplementedError(f"Model.client_forward: {_TRAINING}")

    def ap_forward(self, phi, acts, batch):
        raise NotImplementedError(f"Model.ap_forward: {_TRAINING}")

    # -- decode -----------------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int) -> Cache:
        """Zeroed KV caches in the model's dtype, one per stack."""
        return tuple(tfm.init_stack_cache(self.cfg, stack, batch_size, max_seq, self.dtype,
                                          self.device)
                     for stack in self.stacks)

    @torch.inference_mode()
    def decode_step(self, cache: Cache, tokens: torch.Tensor, index: int
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B, 1) int; index: the tokens' position (host int).
        Writes the cache in place; returns (logits (B, 1, V), cache)."""
        x = self._embed_tokens(tokens)
        for stack, c in zip(self.stacks, cache):
            x, _ = tfm.decode_stack(stack, x, c, index)
        return self.head(self.final_norm(x)), cache


def build_plan(cfg: ModelConfig) -> List[StackPlan]:
    """Static stack layout, which ``tfm.build_stacks`` builds: one
    ``attn_mlp`` stack with each layer's sliding window (0 = global)."""
    if cfg.arch_type != "dense":
        raise tfm.not_ported(cfg.arch_type)
    return [StackPlan("attn_mlp", cfg.n_layers, {"window": tfm._layer_windows(cfg)})]


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model of ``cfg`` with uninitialised parameters on ``device`` (the
    card unless ``device="cpu"``); call :meth:`Model.init` to draw them."""
    plan = build_plan(cfg)
    return Model(cfg, plan, resolve_device(device))


__all__ = ["Model", "StackPlan", "build_model", "build_plan"]
