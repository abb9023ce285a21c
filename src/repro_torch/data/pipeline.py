"""Task construction: client shards, the shared validation set D_o and the
test set, as numpy arrays (the protocol moves each batch to the device when
it samples it)."""
from __future__ import annotations

from typing import Tuple

from ..core.protocol import ClientData
from ..models.cnn import CIFAR_CNN, MNIST_CNN, CNNConfig
from . import synthetic


def build_image_task(name: str, m_clients: int, d_m: int, d_o: int,
                     n_test: int = 7000, seed: int = 0) -> Tuple[ClientData, CNNConfig]:
    """name: 'mnist' | 'cifar10' — returns (ClientData, CNNConfig)."""
    if name == "mnist":
        cfg = MNIST_CNN
        arrs = synthetic.make_classification_data(seed, 10, 28, 1, m_clients, d_m,
                                                  d_o, n_test)
    elif name == "cifar10":
        # lower noise: the deeper CNN gets far fewer updates at reduced
        # scale, so the synthetic task carries more class signal
        cfg = CIFAR_CNN
        arrs = synthetic.make_classification_data(seed, 10, 32, 3, m_clients, d_m,
                                                  d_o, n_test, noise=0.25)
    else:
        raise ValueError(name)
    x, y, x0, y0, xt, yt = arrs
    return ClientData(x=x, y=y, x0=x0, y0=y0, x_test=xt, y_test=yt), cfg
