"""The handoff tamper check: the CUDA kernel (``csrc/tamper_check.cu``) and
its plain PyTorch versions.

Section III-C compares the cut activations that the next round's first
clients re-transmit with the activations the selected cluster reported at
validation time.  For each candidate the check needs two sums over its
(N, D) activation set, ``[sum (ref - recv)^2, sum ref^2]``, and from them
the relative distance ``sqrt(num) / max(sqrt(den), 1e-12)``.

  * :func:`tamper_check` — launches the kernel on f32 or bf16 CUDA tensors
    (bf16 read as it lies, summed in f32, as the reference's kernel casts
    each block): ref and recv (R, N, D) -> sums (R, 2), distances (R,) and
    the verdicts
    ``distances <= tol`` (R,), all R candidates in ONE launch (or (N, D) ->
    (2,), a scalar and a 0-d verdict).  When ref and recv are the same
    storage (the fused round's verify stage) it reads them once.
  * :func:`tamper_check_sums` — the sums alone, through the same launch.
  * :func:`tamper_check_sums_plain`, :func:`tamper_distance_plain` — the same
    in PyTorch, for the CPU and for comparison on the card.

``kernels/ops.py::tamper_verdict`` (and ``tamper_distance`` through it)
picks between them by the tensor's device.  The launcher counts its launches in
``build.LAUNCHES`` (``tamper_check_sums``, ``tamper_check_sums_bf16`` for the
bf16 route).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

#: csrc/tamper_check.cu's kThreads, kUnroll and kMinChunk: a block's
#: threads, the 16-byte loads a thread issues a group an input, and the
#: fewest elements a block takes (so a small input runs on few blocks)
TAMPER_THREADS, TAMPER_UNROLL = 256, 4
TAMPER_MIN_CHUNK = TAMPER_THREADS * 4 * TAMPER_UNROLL
#: the fewest blocks an SM the layout aims for, to keep loads in flight
TAMPER_BLOCKS_PER_SM = 4
#: the elements of one 16-byte load, by input dtype (the chunk's multiple)
TAMPER_VEC = {torch.float32: 4, torch.bfloat16: 8}
#: the kernel's dtype flag
_DTYPE_FLAG = {torch.float32: 0, torch.bfloat16: 1}
#: the guard on the distance's denominator (``ops.tamper_distance``)
DEN_FLOOR = 1e-12
_CONSTANTS = {"kThreads": TAMPER_THREADS, "kUnroll": TAMPER_UNROLL,
              "kMinChunk": TAMPER_MIN_CHUNK}

#: the kernel's ticket counters, one int32 per (device, stream): 0 between
#: launches (the last block of a launch wraps it back)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _as_candidates(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (1, N*D); (R, ...) -> (R, n_elem)."""
    return x.reshape(1, -1) if x.dim() == 2 else x.reshape(x.shape[0], -1)


def tamper_layout(r: int, n_elem: int, sms: int, vec: int = 4) -> Tuple[int, int]:
    """(P, chunk) of the kernel's (P, R) grid on a card of ``sms`` SMs:
    block (p, r) takes elements ``[p * chunk, (p + 1) * chunk)`` of
    candidate r.  P * R is a multiple of ``sms`` with at least
    :data:`TAMPER_BLOCKS_PER_SM` blocks an SM, so every SM streams the same
    bytes; the chunk is a multiple of ``vec`` elements (a 16-byte load's:
    :data:`TAMPER_VEC`) and at least :data:`TAMPER_MIN_CHUNK`, and P chunks
    just cover ``n_elem``."""
    g = math.gcd(r, sms)
    per_cand, per_sm = sms // g, r // g          # P * R = sms * per_sm at P = per_cand
    p = per_cand * -(-TAMPER_BLOCKS_PER_SM // per_sm)
    chunk = max(vec * -(-n_elem // (vec * p)), TAMPER_MIN_CHUNK)
    return -(-n_elem // chunk), chunk


def tamper_check_sums_plain(ref: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tamper_check_sums`: per candidate
    ``[((a - b)**2).sum(), (a * a).sum()]`` in f32."""
    if ref.shape != recv.shape:
        raise ValueError(f"ref {tuple(ref.shape)} and recv {tuple(recv.shape)} differ")
    if ref.dim() == 2:
        a, b = ref.to(torch.float32), recv.to(torch.float32)
        return torch.stack([((a - b) ** 2).sum(), (a * a).sum()])
    return torch.stack([tamper_check_sums_plain(a, b)
                        for a, b in zip(_as_candidates(ref)[:, None],
                                        _as_candidates(recv)[:, None])])


def distance_from_sums(sums: torch.Tensor) -> torch.Tensor:
    """``sqrt(num) / max(sqrt(den), 1e-12)`` over the last axis of (..., 2)
    sums: a NaN stays NaN, as in the reference."""
    return torch.sqrt(sums[..., 0]) / torch.clamp_min(torch.sqrt(sums[..., 1]), DEN_FLOOR)


def tamper_distance_plain(ref: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`tamper_check`'s distances."""
    return distance_from_sums(tamper_check_sums_plain(ref, recv))


def _check_input(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the tamper-check kernel takes CUDA tensors, got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"activations on {x.device} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    if x.dtype not in TAMPER_VEC:
        raise TypeError(f"the tamper-check kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"the tamper-check kernel takes non-empty (N, D) or "
                         f"(R, N, D) activations, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the tamper-check kernel takes contiguous activations")


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return _TICKETS[key]


def tamper_check(ref: torch.Tensor, recv: torch.Tensor, tol: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the one-launch tamper check on f32 or bf16 CUDA tensors (both
    of one dtype): (R, N, D) -> (sums (R, 2), distances (R,), verdicts
    ``distances <= tol`` (R,) bool), all f32 sums; (N, D) -> ((2,), 0-d,
    0-d)."""
    from .build import check_constants, device_limits, load, record_launch
    if ref.shape != recv.shape:
        raise ValueError(f"ref {tuple(ref.shape)} and recv {tuple(recv.shape)} differ")
    if ref.dtype != recv.dtype:
        raise TypeError(f"ref {ref.dtype} and recv {recv.dtype} differ")
    for x in (ref, recv):
        _check_input(x)
    a, b = _as_candidates(ref), _as_candidates(recv)
    r, n_elem = a.shape
    lib = load("tamper_check")
    check_constants("tamper_check", _CONSTANTS)
    p, chunk = tamper_layout(r, n_elem, device_limits(ref.device.index)[0],
                             TAMPER_VEC[ref.dtype])
    # the partials, then the sums and the distances
    out = torch.empty((r * (2 * p + 3),), dtype=torch.float32, device=ref.device)
    sums = out[r * 2 * p: r * (2 * p + 2)].view(r, 2)
    dists = out[r * (2 * p + 2):]
    passed = torch.empty((r,), dtype=torch.bool, device=ref.device)
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = lib.repro_tamper_check(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), sums.data_ptr(), dists.data_ptr(),
        passed.data_ptr(), _ticket(ref.device, stream).data_ptr(), r, n_elem, chunk, p,
        tol, int(a.data_ptr() == b.data_ptr()), _DTYPE_FLAG[ref.dtype], stream)
    record_launch(err, "tamper_check_sums_bf16" if ref.dtype == torch.bfloat16
                  else "tamper_check_sums")
    if ref.dim() == 2:
        return sums[0], dists[0], passed[0]
    return sums, dists, passed


def tamper_check_sums(ref: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """The sums of :func:`tamper_check` (one launch): (R, N, D) -> (R, 2), or
    (N, D) -> (2,)."""
    return tamper_check(ref, recv, math.inf)[0]


__all__ = ["DEN_FLOOR", "TAMPER_BLOCKS_PER_SM", "TAMPER_MIN_CHUNK", "TAMPER_THREADS",
           "TAMPER_UNROLL", "TAMPER_VEC", "distance_from_sums", "tamper_check",
           "tamper_check_sums", "tamper_check_sums_plain", "tamper_distance_plain",
           "tamper_layout"]
