"""Parameters between the reference's layout and the port's modules.

The reference keeps the split CNN's parameters as pytrees of arrays::

    gamma = {"convs": ({"w": (k, k, c_in, c_out), "b": (c_out,)}, ...),
             "cut_fc": {"w": (d_in, d_out), "b": (d_out,)}}
    phi = {"fcs": ({"w": (d_in, d_out), "b": (d_out,)}, ...)}

Here they arrive and leave as numpy arrays (any array type ``np.asarray``
takes).  Convolution kernels go HWIO <-> OIHW; dense kernels keep their
(d_in, d_out) layout.  The round trip is exact.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .models.cnn import APHead, ClientCNN, CNNConfig

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


__all__ = ["from_reference", "to_reference"]
