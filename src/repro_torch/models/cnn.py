"""The paper's split CNNs (Section V-A) as two ``nn.Module`` halves.

MNIST:    conv(1->2, 5x5, pad 2) - pool - conv(2->4, 5x5, pad 2) - pool -
          FC 32 (cut layer) - FC 10.
CIFAR-10: conv(3->32, 3x3) - pool - conv(32->64, 3x3) - pool -
          conv(64->128, 3x3) - pool - FC 256 (cut layer) - FC 128 - FC 64 - FC 10.

The client half (gamma, :class:`ClientCNN`) ends at the cut-layer output; the
AP half (phi, :class:`APHead`) consumes it.  Images arrive NHWC, as in the
reference; the convolutions run NCHW inside the module, and the features are
flattened back in NHWC order before ``cut_fc`` so that the reference's
``cut_fc`` weights load unchanged.  Dense kernels keep the reference's
(d_in, d_out) layout.

The batched round trains R clusters at once on cluster-stacked halves
(:class:`StackedClientCNN`, :class:`StackedAPHead`): every parameter carries
a leading R axis, the convolutions are grouped (``groups=R`` over
``(B, R*C, H, W)``) and the dense layers are batched products, so cluster r
computes exactly what a plain module holding slot r computes.  Their
``parameters()`` come in the plain modules' order, one stacked tensor per
plain parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import dense_init


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int
    in_channels: int
    conv_channels: Tuple[int, ...]
    kernel: int
    padding: int
    fc_sizes: Tuple[int, ...]         # first entry is the cut layer width d_c
    n_classes: int = 10

    @property
    def d_cut(self) -> int:
        return self.fc_sizes[0]

    @property
    def flat_dim(self) -> int:
        s = self.image_size
        for _ in self.conv_channels:
            s = s // 2
        return s * s * self.conv_channels[-1]


MNIST_CNN = CNNConfig(name="mnist_cnn", image_size=28, in_channels=1,
                      conv_channels=(2, 4), kernel=5, padding=2,
                      fc_sizes=(32,))
CIFAR_CNN = CNNConfig(name="cifar_cnn", image_size=32, in_channels=3,
                      conv_channels=(32, 64, 128), kernel=3, padding=1,
                      fc_sizes=(256, 128, 64))


class Dense(nn.Module):
    """``x @ w + b`` with a (d_in, d_out) kernel."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((d_in, d_out)))
        self.b = nn.Parameter(torch.zeros((d_out,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class Conv(nn.Module):
    """Stride-1 square convolution with an OIHW kernel (NCHW input)."""

    def __init__(self, c_in: int, c_out: int, k: int, padding: int):
        super().__init__()
        self.padding = padding
        self.w = nn.Parameter(torch.zeros((c_out, c_in, k, k)))
        self.b = nn.Parameter(torch.zeros((c_out,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.w, self.b, padding=self.padding)


class ClientCNN(nn.Module):
    """gamma: the conv blocks and the cut FC.  (B, H, W, C) -> (B, d_c)."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        convs, c_in = [], cfg.in_channels
        for c_out in cfg.conv_channels:
            convs.append(Conv(c_in, c_out, cfg.kernel, cfg.padding))
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.cut_fc = Dense(cfg.flat_dim, cfg.d_cut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            # VALID 2x2 max-pool, as the reference's reduce_window
            x = F.max_pool2d(F.relu(conv(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.cut_fc(x))


class APHead(nn.Module):
    """phi: the AP-side FC stack.  Cut activations -> logits (B, n_classes)."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        dims = (cfg.d_cut,) + tuple(cfg.fc_sizes[1:]) + (cfg.n_classes,)
        self.fcs = nn.ModuleList(Dense(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, acts: torch.Tensor) -> torch.Tensor:
        x = acts
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = F.relu(x)
        return x


class StackedConv(nn.Module):
    """R stride-1 convolutions as one grouped convolution: kernels
    (R, C_out, C_in, k, k), input (B, R*C_in, H, W)."""

    def __init__(self, r: int, c_in: int, c_out: int, k: int, padding: int):
        super().__init__()
        self.padding = padding
        self.w = nn.Parameter(torch.zeros((r, c_out, c_in, k, k)))
        self.b = nn.Parameter(torch.zeros((r, c_out)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, c_out = self.b.shape
        return F.conv2d(x, self.w.reshape((r * c_out,) + self.w.shape[2:]),
                        self.b.reshape(r * c_out), padding=self.padding,
                        groups=r)


class StackedDense(nn.Module):
    """R dense layers as one batched product: (R, B, d_in) -> (R, B, d_out)."""

    def __init__(self, r: int, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros((r, d_in, d_out)))
        self.b = nn.Parameter(torch.zeros((r, d_out)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.b[:, None, :], x, self.w)


class StackedClientCNN(nn.Module):
    """R clusters' gamma.  (R, B, H, W, C) -> (R, B, d_c)."""

    def __init__(self, cfg: CNNConfig, r: int):
        super().__init__()
        convs, c_in = [], cfg.in_channels
        for c_out in cfg.conv_channels:
            convs.append(StackedConv(r, c_in, c_out, cfg.kernel, cfg.padding))
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.cut_fc = StackedDense(r, cfg.flat_dim, cfg.d_cut)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, b, h, w, c = x.shape
        x = x.permute(1, 0, 4, 2, 3).reshape(b, r * c, h, w)
        for conv in self.convs:
            # VALID 2x2 max-pool, as the reference's reduce_window
            x = F.max_pool2d(F.relu(conv(x)), 2)
        _, rc, h, w = x.shape
        # back to (R, B, H, W, C): the reference's NHWC flatten per cluster
        x = x.reshape(b, r, rc // r, h, w).permute(1, 0, 3, 4, 2).reshape(r, b, -1)
        return F.relu(self.cut_fc(x))


class StackedAPHead(nn.Module):
    """R clusters' phi.  (R, B, d_c) -> logits (R, B, n_classes)."""

    def __init__(self, cfg: CNNConfig, r: int):
        super().__init__()
        dims = (cfg.d_cut,) + tuple(cfg.fc_sizes[1:]) + (cfg.n_classes,)
        self.fcs = nn.ModuleList(StackedDense(r, a, b)
                                 for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, acts: torch.Tensor) -> torch.Tensor:
        x = acts
        for i, fc in enumerate(self.fcs):
            x = fc(x)
            if i < len(self.fcs) - 1:
                x = F.relu(x)
        return x


def cnn_init(generator: torch.Generator, cfg: CNNConfig) -> Tuple[ClientCNN, APHead]:
    """(gamma, phi) with the reference's initialisers (truncated normal,
    fan-in scaled; zero biases), drawn in the reference's order on
    ``generator`` (a CPU generator gives the same parameters wherever the
    modules then go)."""
    gamma, phi = ClientCNN(cfg), APHead(cfg)
    with torch.no_grad():
        c_in = cfg.in_channels
        for conv, c_out in zip(gamma.convs, cfg.conv_channels):
            k = cfg.kernel
            w = torch.empty((k, k, c_in, c_out))          # HWIO, the reference's layout
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            conv.w.copy_((w / math.sqrt(k * k * c_in)).permute(3, 2, 0, 1))
            c_in = c_out
        gamma.cut_fc.w.copy_(dense_init(generator, cfg.flat_dim, cfg.d_cut))
        for fc in phi.fcs:
            fc.w.copy_(dense_init(generator, *fc.w.shape))
    return gamma, phi


def cnn_stacked(cfg: CNNConfig, r: int) -> Tuple[StackedClientCNN, StackedAPHead]:
    """Zeroed cluster-stacked halves for R clusters (the batched round loads
    theta into every slot, :func:`repro_torch.core.split.stack_params`)."""
    return StackedClientCNN(cfg, r), StackedAPHead(cfg, r)


__all__ = ["APHead", "CIFAR_CNN", "CNNConfig", "ClientCNN", "Conv", "Dense",
           "MNIST_CNN", "StackedAPHead", "StackedClientCNN", "StackedConv",
           "StackedDense", "cnn_init", "cnn_stacked"]
