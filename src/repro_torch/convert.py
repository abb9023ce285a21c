"""Parameters between the reference's layout and the port's modules.

The reference keeps the split CNN's parameters as pytrees of arrays::

    gamma = {"convs": ({"w": (k, k, c_in, c_out), "b": (c_out,)}, ...),
             "cut_fc": {"w": (d_in, d_out), "b": (d_out,)}}
    phi = {"fcs": ({"w": (d_in, d_out), "b": (d_out,)}, ...)}

Here they arrive and leave as numpy arrays (any array type ``np.asarray``
takes).  Convolution kernels go HWIO <-> OIHW; dense kernels keep their
(d_in, d_out) layout.  The round trip is exact.

The batched round's cluster-stacked halves hold R such parameter sets:
:func:`stack_reference` stacks R converted reference sets and
:func:`slot_to_reference` takes slot r back out.

The LM's parameters are the pytree of the reference's ``Model.init``::

    {"embed": (V, d), "final_norm": {"scale": (d,)}, "head": {"w": (d, V)},
     "stacks": ({"ln1": {"scale": (n, d)}, "ln2": ...,
                 "attn": {"wq": {"w": (n, d, H*D), "b"?}, "wk", "wv", "wo",
                          "q_norm"?: {"scale": (n, D)}, "k_norm"?},
                 "mlp": {"gate": {"w"}, "up": {"w"}, "down": {"w"}}},)}

An xLSTM model's stacks hold ``{"ln": {"scale"}, "mixer": {...}}`` the same
way: an mLSTM layer's mixer ``up``, ``wq``, ``wk``, ``wv``, ``w_if`` (+ ``b``),
``out_norm`` and ``down``; an sLSTM layer's ``w_in`` (+ ``b``), the bare
array ``r`` (n, H, dh, 4dh), ``out_norm`` and ``down``.

A stack's leaves carry the layer axis first; :func:`lm_from_reference` maps
it onto the stack's ``nn.ModuleList`` (a layer's parameter names are the
pytree's paths, joined by dots) and :func:`lm_to_reference` stacks it back.
The split view travels the same way: :func:`lm_split_from_reference` takes
the reference's ``split_params`` pair ``(gamma, phi)`` to the port's
``(ClientLM, APLM)`` and :func:`lm_split_to_reference` back.
Values travel as f32 (numpy has no bf16); a bf16 model's round trip is
exact all the same.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .models.cnn import (APHead, ClientCNN, CNNConfig, StackedAPHead,
                         StackedClientCNN)
from .models.config import ModelConfig
from .models.model import APLM, ClientLM, Model, build_model

Tree = Dict[str, Any]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def from_reference(cfg: CNNConfig, gamma: Tree, phi: Tree
                   ) -> Tuple[ClientCNN, APHead]:
    """Reference (gamma, phi) pytrees -> the port's (ClientCNN, APHead), on
    the CPU."""
    g_mod, p_mod = ClientCNN(cfg), APHead(cfg)
    if len(gamma["convs"]) != len(g_mod.convs) or len(phi["fcs"]) != len(p_mod.fcs):
        raise ValueError(f"parameter tree does not match {cfg.name}")
    with torch.no_grad():
        for conv, p in zip(g_mod.convs, gamma["convs"]):
            conv.w.copy_(_tensor(p["w"]).permute(3, 2, 0, 1))
            conv.b.copy_(_tensor(p["b"]))
        dense = [(g_mod.cut_fc, gamma["cut_fc"])] + list(zip(p_mod.fcs, phi["fcs"]))
        for fc, p in dense:
            fc.w.copy_(_tensor(p["w"]))
            fc.b.copy_(_tensor(p["b"]))
    return g_mod, p_mod


def to_reference(gamma: ClientCNN, phi: APHead) -> Tuple[Tree, Tree]:
    """The port's modules -> reference-layout (gamma, phi) numpy pytrees."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().copy()

    def dense(fc) -> Tree:
        return {"w": arr(fc.w), "b": arr(fc.b)}

    g = {"convs": tuple({"w": arr(c.w.permute(2, 3, 1, 0)), "b": arr(c.b)}
                        for c in gamma.convs),
         "cut_fc": dense(gamma.cut_fc)}
    p = {"fcs": tuple(dense(fc) for fc in phi.fcs)}
    return g, p


@torch.no_grad()
def stack_reference(cfg: CNNConfig, trees: Sequence[Tuple[Tree, Tree]]
                    ) -> Tuple[StackedClientCNN, StackedAPHead]:
    """R reference (gamma, phi) pytree pairs -> the port's cluster-stacked
    halves, slot r holding pair r, on the CPU."""
    sg, sp = StackedClientCNN(cfg, len(trees)), StackedAPHead(cfg, len(trees))
    plain = [from_reference(cfg, g, p) for g, p in trees]
    for stacked, i in ((sg, 0), (sp, 1)):
        for big, *slots in zip(stacked.parameters(),
                               *(pair[i].parameters() for pair in plain)):
            big.copy_(torch.stack(slots))
    return sg, sp


def slot_to_reference(cfg: CNNConfig, gamma: StackedClientCNN, phi: StackedAPHead,
                      r: int) -> Tuple[Tree, Tree]:
    """Slot ``r`` of cluster-stacked halves -> reference-layout numpy
    pytrees."""
    from .core.split import unstack_slot
    return to_reference(unstack_slot(ClientCNN(cfg), gamma, r),
                        unstack_slot(APHead(cfg), phi, r))


def _paths(tree: Tree, prefix: str = "") -> Iterator[str]:
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from _paths(sub, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}"


def _leaf(tree: Tree, path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


@torch.no_grad()
def lm_from_reference(cfg: ModelConfig, params: Tree) -> Model:
    """The reference's LM parameter pytree (dense or xLSTM) -> the port's
    :class:`Model`, on the CPU."""
    model = build_model(cfg, "cpu")
    if len(params["stacks"]) != len(model.stacks):
        raise ValueError(f"{len(params['stacks'])} stacks in the tree, {len(model.stacks)} "
                         f"in {cfg.name}")
    model.embedding.copy_(_tensor(params["embed"]))
    for stack, tree in zip(model.stacks, params["stacks"]):
        names = sorted(name for name, _ in stack.layers[0].named_parameters())
        if sorted(_paths(tree)) != names:
            raise ValueError(f"stack leaves {sorted(_paths(tree))} != {names}")
        for name in names:
            leaf = _tensor(_leaf(tree, name))
            if leaf.shape[0] != stack.n:
                raise ValueError(f"{name}: {leaf.shape[0]} layers in the tree, {stack.n} "
                                 f"in the stack")
            for layer, value in zip(stack.layers, leaf):
                layer.get_parameter(name).copy_(value)
    model.final_norm.scale.copy_(_tensor(params["final_norm"]["scale"]))
    model.head.w.copy_(_tensor(params["head"]["w"]))
    return model


def lm_to_reference(model: Model) -> Tree:
    """The port's :class:`Model` -> the reference's parameter pytree (numpy
    f32)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    stacks = []
    for stack in model.stacks:
        tree: Tree = {}
        for name, _ in stack.layers[0].named_parameters():
            *parents, last = name.split(".")
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[last] = np.stack([arr(layer.get_parameter(name)) for layer in stack.layers])
        stacks.append(tree)
    return {"embed": arr(model.embedding), "stacks": tuple(stacks),
            "final_norm": {"scale": arr(model.final_norm.scale)},
            "head": {"w": arr(model.head.w)}}


def _concat_stacks(a: Tree, b: Tree) -> Tree:
    return {k: (_concat_stacks(v, b[k]) if isinstance(v, dict)
                else np.concatenate([np.asarray(v), np.asarray(b[k])]))
            for k, v in a.items()}


def _slice_tree(tree: Tree, lo: int, hi: int) -> Tree:
    return {k: (_slice_tree(v, lo, hi) if isinstance(v, dict) else np.asarray(v)[lo:hi])
            for k, v in tree.items()}


def lm_split_from_reference(cfg: ModelConfig, gamma: Tree, phi: Tree
                            ) -> Tuple[ClientLM, APLM]:
    """A reference split ``(gamma, phi)`` (its ``Model.split_params``) -> the
    port's halves (``ClientLM``, ``APLM``), on the CPU: merged as the
    reference's ``merge_params`` does, converted, and split again."""
    model = build_model(cfg, "cpu")
    _, _, slices = model.split_plans()
    stacks, ci, ai = [], 0, 0
    for _, take, total in slices:
        if take == total:
            stacks.append(gamma["stacks"][ci]); ci += 1
        elif take == 0:
            stacks.append(phi["stacks"][ai]); ai += 1
        else:
            stacks.append(_concat_stacks(gamma["stacks"][ci], phi["stacks"][ai]))
            ci += 1; ai += 1
    params = {"embed": gamma["embed"], "stacks": tuple(stacks),
              "final_norm": phi["final_norm"], "head": phi["head"]}
    return lm_from_reference(cfg, params).split_params()


def lm_split_to_reference(model: Model, gamma: ClientLM, phi: APLM) -> Tuple[Tree, Tree]:
    """The port's halves -> the reference's split ``(gamma, phi)`` pytrees
    (numpy f32), as its ``split_params`` lays them out; ``model`` gives the
    plan."""
    tree = lm_to_reference(model.merge_params(gamma, phi))
    _, _, slices = model.split_plans()
    client, ap = [], []
    for (_, take, total), st in zip(slices, tree["stacks"]):
        if take == total:
            client.append(st)
        elif take == 0:
            ap.append(st)
        else:
            client.append(_slice_tree(st, 0, take))
            ap.append(_slice_tree(st, take, total))
    return ({"embed": tree["embed"], "stacks": tuple(client)},
            {"stacks": tuple(ap), "final_norm": tree["final_norm"], "head": tree["head"]})


__all__ = ["from_reference", "lm_from_reference", "lm_split_from_reference",
           "lm_split_to_reference", "lm_to_reference", "slot_to_reference",
           "stack_reference", "to_reference"]
