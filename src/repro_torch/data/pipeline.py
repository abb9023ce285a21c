"""Task construction: client shards, the shared validation set D_o and the
test set, as numpy arrays (the protocol moves each batch to the device when
it samples it): images for the split CNNs, token sequences for an LM; the
non-IID relabelling and the mini-batch stream of the reference's pipeline."""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..core.protocol import ClientData
from ..models.cnn import CIFAR_CNN, MNIST_CNN, CNNConfig
from . import synthetic


def dirichlet_relabel(data: ClientData, alpha: float, seed: int = 0) -> ClientData:
    """Beyond-paper non-IID ablation: resample each client's shard with a
    Dirichlet(alpha) class prior (alpha -> inf recovers the paper's i.i.d.
    assumption; alpha ~ 0.1 gives heavily skewed clients).  The shared set
    D_o and the test set stay i.i.d.  The numpy draws follow the
    reference's order, so the shards are its bits."""
    rng = np.random.default_rng(seed)
    m = data.x.shape[0]
    n_classes = int(data.y.max()) + 1
    pool_x = data.x.reshape(-1, *data.x.shape[2:])
    pool_y = data.y.reshape(-1)
    by_class = [np.where(pool_y == c)[0] for c in range(n_classes)]
    d_m = data.x.shape[1]
    xs, ys = [], []
    for _ in range(m):
        prior = rng.dirichlet([alpha] * n_classes)
        counts = rng.multinomial(d_m, prior)
        idx = np.concatenate([
            rng.choice(by_class[c], size=k, replace=True)
            for c, k in enumerate(counts) if k > 0])
        rng.shuffle(idx)
        xs.append(pool_x[idx])
        ys.append(pool_y[idx])
    return ClientData(x=np.stack(xs), y=np.stack(ys), x0=data.x0, y0=data.y0,
                      x_test=data.x_test, y_test=data.y_test)


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


def minibatches(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
                batch: int, steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` mini-batches of ``batch`` samples drawn with replacement
    (host arrays; the caller moves them)."""
    for _ in range(steps):
        idx = rng.integers(0, x.shape[0], size=batch)
        yield x[idx], y[idx]
