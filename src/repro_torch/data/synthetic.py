"""Synthetic data (numpy; copied from the reference
``repro/data/synthetic.py`` so that the same seed gives the same arrays).

Images: each class c has a fixed smooth template image t_c; a sample is
``a * t_c + sigma * noise`` with per-sample amplitude jitter.  Tokens: a
random, strongly peaked Markov chain over the vocabulary.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth(img: np.ndarray, k: int = 3, iters: int = 2) -> np.ndarray:
    """Cheap box-blur smoothing to make templates low-frequency."""
    for _ in range(iters):
        pad = np.pad(img, (((k - 1) // 2, k // 2), ((k - 1) // 2, k // 2), (0, 0)),
                     mode="edge")
        acc = np.zeros_like(img)
        for dy in range(k):
            for dx in range(k):
                acc += pad[dy : dy + img.shape[0], dx : dx + img.shape[1], :]
        img = acc / (k * k)
    return img


def make_templates(rng: np.random.Generator, n_classes: int, size: int,
                   channels: int) -> np.ndarray:
    t = rng.normal(0, 1, (n_classes, size, size, channels)).astype(np.float32)
    t = np.stack([_smooth(x) for x in t])
    t /= np.maximum(np.abs(t).max(axis=(1, 2, 3), keepdims=True), 1e-6)
    return t


def sample_images(rng: np.random.Generator, templates: np.ndarray, n: int,
                  noise: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    n_classes = templates.shape[0]
    y = rng.integers(0, n_classes, size=n)
    amp = rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
    x = amp * templates[y] + noise * rng.normal(0, 1, (n,) + templates.shape[1:]).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def make_classification_data(seed: int, n_classes: int, size: int, channels: int,
                             m_clients: int, d_m: int, d_o: int, n_test: int,
                             noise: float = 0.35):
    """Returns a ``ClientData``-shaped tuple of arrays."""
    rng = np.random.default_rng(seed)
    templates = make_templates(rng, n_classes, size, channels)
    xs, ys = [], []
    for _ in range(m_clients):
        x, y = sample_images(rng, templates, d_m, noise)
        xs.append(x)
        ys.append(y)
    x0, y0 = sample_images(rng, templates, d_o, noise)
    xt, yt = sample_images(rng, templates, n_test, noise)
    return (np.stack(xs), np.stack(ys), x0, y0, xt, yt)


# ---------------------------------------------------------------------------
# token data (Markov language)
# ---------------------------------------------------------------------------

def make_markov_tokens(seed: int, vocab: int, n_seqs: int, seq_len: int,
                       order_bias: float = 6.0) -> np.ndarray:
    """Sequences from a random but strongly-peaked Markov chain: next-token
    prediction is learnable well above uniform.  Builds a dense (vocab,
    vocab) transition matrix, so it suits small vocabularies only."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (vocab, vocab)) * order_bias
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    out = np.empty((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        out[:, t] = state
        u = rng.random((n_seqs, 1))
        state = (probs[state].cumsum(axis=1) > u).argmax(axis=1)
    return out


def lm_batch(tokens: np.ndarray):
    """tokens (N, S+1) -> inputs/labels for next-token prediction."""
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
