"""A minimal optimizer library over trees of tensors (the reference's
``repro/optim/optim.py``).

``Optimizer`` is an (init, update) pair over dicts (nested or not), lists
and tuples of tensors:

    opt = adamw(warmup_cosine(3e-4, 100, 10_000))
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    apply_updates(params, updates)          # p += u, in place

The reference's dtype rules hold: the step is an int32 tensor on the
parameters' device, the schedule is evaluated on it there, ``m`` and ``v``
are f32, the bias corrections are computed in f32 and each update is cast to
its parameter's dtype.  A bf16 leaf's update is computed in f32 and rounded
once, as the reference's f32 learning rate times a bf16 gradient promotes
to f32 (torch would round the 0-d f32 rate to bf16 first).  Nothing here
reads a tensor back to the host: the clip's global norm stays a device
tensor.  This is plain PyTorch, as the reference computes it outside any
kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

Tree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``),
    keeping its dict/list/tuple structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The tensors of ``tree`` in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[[Tree, Tree, Tree], Tuple[Tree, Tree]]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1) -> Schedule:
    def fn(step):
        t = torch.clamp(step / max(total_steps, 1), max=1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        w = torch.clamp(step / max(warmup, 1), max=1.0)
        return torch.where(step < warmup, lr * w, cos(step - warmup))
    return fn


def _as_schedule(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def _step_of(params: Tree) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """``grads`` scaled so that their global L2 norm is at most ``max_norm``,
    and that norm (a 0-d f32 device tensor, computed in f32)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def sgd(lr, momentum: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        state = {"step": _step_of(params)}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(grads, state, params=None):
        lr_t = sched(state["step"])
        if momentum:
            # the coefficient in the leaf's dtype, as the reference's weakly
            # typed Python float is (bf16(0.9) for a bf16 leaf)
            mu = tree_map(lambda m, g: float(torch.tensor(momentum, dtype=m.dtype)) * m + g,
                          state["mu"], grads)
            updates = tree_map(lambda m: (-lr_t * m.to(torch.float32)).to(m.dtype), mu)
            new_state = {"step": state["step"] + 1, "mu": mu}
        else:
            updates = tree_map(lambda g: (-lr_t * g.to(torch.float32)).to(g.dtype), grads)
            new_state = {"step": state["step"] + 1}
        return updates, new_state

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        f32 = lambda p: torch.zeros_like(p, dtype=torch.float32)   # noqa: E731
        return {"step": _step_of(params), "m": tree_map(f32, params),
                "v": tree_map(f32, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr_t = sched(state["step"])
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                     state["v"], grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u.to(p.dtype)

        return tree_map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``p += u`` for every leaf, in place, in the parameter's dtype (the
    reference's ``jax.tree.map(lambda p, u: p + u, ...)``).  Returns
    ``params``."""
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params


__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm", "constant_schedule",
           "cosine_schedule", "sgd", "tree_leaves", "tree_map", "warmup_cosine"]
