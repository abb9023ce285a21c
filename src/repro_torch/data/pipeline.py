"""Task construction: client shards, the shared validation set D_o and the
test set, as numpy arrays (the protocol moves each batch to the device when
it samples it): images for the split CNNs, token sequences for an LM."""
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


def build_lm_task(vocab: int, seq_len: int, m_clients: int, d_m: int, d_o: int,
                  n_test: int = 64, seed: int = 0) -> ClientData:
    """Token-sequence task for running the protocol over an LM: x arrays hold
    input tokens (int32), y arrays the next-token labels.  The tokens come
    from :func:`synthetic.make_markov_tokens`, which holds a dense (vocab,
    vocab) matrix: ``vocab`` is the task's token range, which may be far
    below the model's head."""
    toks = synthetic.make_markov_tokens(seed, vocab, m_clients * d_m + d_o + n_test,
                                        seq_len + 1)
    x_all, y_all = toks[:, :-1], toks[:, 1:]
    n_cl = m_clients * d_m
    x = x_all[:n_cl].reshape(m_clients, d_m, seq_len)
    y = y_all[:n_cl].reshape(m_clients, d_m, seq_len)
    x0 = x_all[n_cl : n_cl + d_o]
    y0 = y_all[n_cl : n_cl + d_o]
    xt = x_all[n_cl + d_o :]
    yt = y_all[n_cl + d_o :]
    return ClientData(x=x, y=y, x0=x0, y0=y0, x_test=xt, y_test=yt)
