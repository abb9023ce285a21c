"""Task construction and the host pipeline.

Client shards, the shared validation set D_o and the test set, as numpy
arrays (the protocol moves each batch to the device when it samples it):
images for the split CNNs, token sequences for an LM; the non-IID
relabelling and the mini-batch stream of the reference's pipeline.

The host pipeline: :func:`plan_blocks` cuts a run into round blocks that
end at sync rounds, :class:`RoundFeeder` assembles round (or block) t+1 on
a background thread while the card runs round t, and :class:`DeviceStager`
moves an assembled payload to a CUDA device without blocking either thread:
pinned host buffers allocated once and reused, copied on a stream of its
own.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.protocol import ClientData
from ..models.cnn import CIFAR_CNN, MNIST_CNN, CNNConfig
from ..telemetry import NULL_SESSION
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


# ---------------------------------------------------------------------------
# round blocks and the double-buffered host pipeline
# ---------------------------------------------------------------------------

def plan_blocks(start: int, stop: int, block: int,
                is_sync: Optional[Callable[[int], bool]] = None):
    """Rounds ``[start, stop)`` as ``(t0, k)`` segments of at most
    ``block`` consecutive rounds.  A segment ENDS at the first sync round
    it reaches — a round whose state the host must see before the next
    round runs (an eval or a checkpoint round), since a block surfaces theta
    only after its last round.  ``is_sync=None``: no sync rounds; ``block=1``
    gives one segment a round.  The segments tile the range in order."""
    if block < 1:
        raise ValueError(f"block={block} must be >= 1")
    segments = []
    t = start
    while t < stop:
        k = lane_block_len(t, stop, block, is_sync)
        segments.append((t, k))
        t += k
    return segments


def lane_block_len(t: int, stop: int, block: int,
                   is_sync: Optional[Callable[[int], bool]] = None) -> int:
    """The length of the :func:`plan_blocks` segment that starts at round
    ``t``: the one copy of the rule that a sync round ends a segment."""
    k = 1
    while (k < block and t + k < stop
           and not (is_sync is not None and is_sync(t + k - 1))):
        k += 1
    return k


class RoundFeeder:
    """Host-side round assembly one step ahead of the card.

    ``make_round(t)`` — the caller's closure that samples one round's (or
    block's) payload — runs on ONE background thread, strictly in ascending
    ``t``, so the numpy stream and the seed generator see exactly the calls
    the synchronous loop would make, only earlier.  At most ``depth``
    assembled payloads wait ahead of the consumer (``depth=1`` is double
    buffering); ``depth=0`` assembles synchronously in :meth:`get`, the
    bound the drivers apply where round t+1's sampling depends on round t's
    outcome.  An exception in ``make_round`` is raised again from
    :meth:`get` at the round that failed.  Always :meth:`close` (or use as a
    context manager), so that an early exit unblocks the producer."""

    def __init__(self, make_round: Callable[[int], Any], start: int, stop: int,
                 depth: int = 1, telemetry=None):
        self._make_round = make_round
        self._next = start
        self._tel = NULL_SESSION if telemetry is None else telemetry
        self._thread: Optional[threading.Thread] = None
        if depth <= 0 or stop <= start:
            return
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(start, stop),
                                        name="pigeon-round-feeder", daemon=True)
        self._thread.start()

    def _produce(self, start: int, stop: int) -> None:
        for t in range(start, stop):
            try:
                with self._tel.span("feeder.assemble", round=t):
                    item = (t, self._make_round(t), None)
            except BaseException as e:  # noqa: BLE001 — relayed to the consumer
                item = (t, None, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set() or item[2] is not None:
                return

    def get(self, t: int) -> Any:
        """The payload of round ``t``; rounds are taken in ascending order."""
        if self._next != t:
            raise RuntimeError(f"RoundFeeder consumed out of order: expected "
                               f"t={self._next}, got t={t}")
        self._next = t + 1
        if self._thread is None:            # depth 0: synchronous
            return self._make_round(t)
        got_t, payload, err = self._q.get()
        if err is not None:
            raise err
        if got_t != t:
            raise RuntimeError(f"RoundFeeder produced t={got_t}, wanted t={t}")
        return payload

    def qsize(self) -> int:
        """Assembled payloads waiting ahead of the consumer (the telemetry
        feeder-depth gauge); 0 when synchronous."""
        q = getattr(self, "_q", None)
        return q.qsize() if q is not None and self._thread is not None else 0

    def close(self) -> None:
        """Stop the producer; safe to call again and after the last round."""
        if self._thread is None:
            return
        self._stop.set()
        try:                                # unblock a producer stuck on put()
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self._thread = None

    def __enter__(self) -> "RoundFeeder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class Staged:
    """A payload whose tensors a :class:`DeviceStager` is copying to the
    card: ``payload`` is usable on the current stream after
    :meth:`DeviceStager.adopt`."""
    payload: Any
    event: Any          # torch.cuda.Event recorded after the copies


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


class DeviceStager:
    """Moves assembled host payloads to a CUDA device without blocking.

    A copy from pageable memory queues on the default stream, behind the
    round the card is running, and blocks the thread that issued it: the
    feeder would overlap nothing.  So the batches are gathered straight into
    pinned host buffers — ``slots`` sets of them, allocated once and reused
    (a pinned allocation of a block's size costs about what the gather
    does) — and copied ``non_blocking`` on a stream of the stager's own,
    with an event recorded after the copies.  A slot is refilled only after
    its last copy's event has completed (polled, never a blocking wait, so
    the producer thread makes no host sync).  The consumer adopts (:meth:`adopt`)
    a :class:`Staged` payload: its current stream waits on the event and
    every tensor is marked used there (``record_stream``), so the caching
    allocator does not hand the memory out again while the round runs."""

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = device
        self._stream = torch.cuda.Stream(device)
        self._bufs: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * slots
        self._events: List[Any] = [None] * slots
        self._next = 0
        self._slot = 0

    def host_buffers(self, specs: Sequence[Tuple[Tuple[int, ...], np.dtype]]
                     ) -> Tuple[np.ndarray, ...]:
        """Numpy views of the next slot's pinned buffers, one per ``(shape,
        dtype)``; a slot grows when a request outsizes it (a block's first
        axis varies with its length) and is reused otherwise."""
        i = self._slot = self._next
        self._next = (i + 1) % len(self._bufs)
        ev = self._events[i]
        while ev is not None and not ev.query():
            time.sleep(1e-4)
        bufs = self._bufs[i]
        fits = bufs is not None and len(bufs) == len(specs) and all(
            b.numel() >= int(np.prod(shape)) and b.numpy().dtype == np.dtype(dt)
            for b, (shape, dt) in zip(bufs, specs))
        if not fits:
            bufs = self._bufs[i] = tuple(
                torch.empty(int(np.prod(shape)),
                            dtype=torch.from_numpy(np.empty(0, dt)).dtype,
                            pin_memory=True) for shape, dt in specs)
        return tuple(b[:int(np.prod(shape))].numpy().reshape(shape)
                     for b, (shape, _) in zip(bufs, specs))

    def copy(self, xs: np.ndarray, ys: np.ndarray, small: Any,
             rest: Tuple = ()) -> Staged:
        """Copy the last slot's buffers ``xs``/``ys`` and the small tensors
        of ``small`` (an AttackVec, or a tuple of them) to the device on the
        stager's stream: ``Staged((xs, ys, small', *rest), event)``."""
        with torch.cuda.stream(self._stream):
            xs_d = torch.from_numpy(xs).to(self.device, non_blocking=True)
            ys_d = torch.from_numpy(ys).to(self.device, non_blocking=True)
            small_d = _to_device(small, self.device)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        self._events[self._slot] = ev
        return Staged((xs_d, ys_d, small_d, *rest), ev)

    @staticmethod
    def adopt(item: Any) -> Any:
        """The payload of a :class:`Staged` item, usable on the current
        stream; any other item as it is (a CPU run stages nothing)."""
        if not isinstance(item, Staged):
            return item
        stream = torch.cuda.current_stream()
        stream.wait_event(item.event)
        for t in _tensors(item.payload):
            if t.device.type == "cuda":
                t.record_stream(stream)
        return item.payload


def _to_device(small: Any, device: torch.device) -> Any:
    if isinstance(small, (list, tuple)):
        return type(small)(_to_device(v, device) for v in small)
    return small.to(device, non_blocking=True)


__all__ = ["DeviceStager", "RoundFeeder", "Staged", "build_image_task", "build_lm_task",
           "dirichlet_relabel", "lane_block_len", "minibatches", "plan_blocks"]
