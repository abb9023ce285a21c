"""The handoff tamper check's sums: the CUDA kernel
(``csrc/tamper_check.cu``) and its plain PyTorch version.

Section III-C compares the cut activations that the next round's first
clients re-transmit with the activations the selected cluster reported at
validation time.  For each candidate the check needs two sums over its
(N, D) activation set: ``[sum (ref - recv)^2, sum ref^2]``.

  * :func:`tamper_check_sums` — launches the kernel on CUDA tensors: ref and
    recv (R, N, D) -> (R, 2) f32, all R candidates in one call (or (N, D) ->
    (2,)).
  * :func:`tamper_check_sums_plain` — the same sums in PyTorch, for the CPU
    and for comparison on the card.

``kernels/ops.py::tamper_distance`` picks between them by the tensor's
device and takes the relative distance.  The launcher counts its launches in
``build.LAUNCHES``.
"""
from __future__ import annotations

import torch


def _as_candidates(x: torch.Tensor) -> torch.Tensor:
    """(N, D) -> (1, N*D); (R, ...) -> (R, n_elem)."""
    return x.reshape(1, -1) if x.dim() == 2 else x.reshape(x.shape[0], -1)


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


def tamper_check_sums(ref: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """Launch the two-pass sums kernel on f32 CUDA tensors: (R, N, D) ->
    (R, 2), or (N, D) -> (2,)."""
    from .build import load, record_launch
    if ref.shape != recv.shape:
        raise ValueError(f"ref {tuple(ref.shape)} and recv {tuple(recv.shape)} differ")
    for x in (ref, recv):
        if x.device.type != "cuda":
            raise ValueError(f"the tamper-check kernel takes CUDA tensors, got {x.device}")
        if x.device.index != torch.cuda.current_device():
            raise ValueError(f"activations on {x.device} but the current device "
                             f"is cuda:{torch.cuda.current_device()}")
        if x.dtype != torch.float32:
            raise TypeError(f"the tamper-check kernel takes float32, got {x.dtype}")
        if x.dim() < 2 or x.numel() == 0:
            raise ValueError(f"the tamper-check kernel takes non-empty (N, D) or "
                             f"(R, N, D) activations, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("the tamper-check kernel takes contiguous activations")
    a, b = _as_candidates(ref), _as_candidates(recv)
    r, n_elem = a.shape
    lib = load("tamper_check")
    p = -(-n_elem // lib.repro_tamper_check_chunk())
    partial = torch.empty((r, p, 2), dtype=torch.float32, device=ref.device)
    out = torch.empty((r, 2), dtype=torch.float32, device=ref.device)
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    err = lib.repro_tamper_check_sums(a.data_ptr(), b.data_ptr(), partial.data_ptr(),
                                      out.data_ptr(), r, n_elem, p, stream)
    record_launch(err, "tamper_check_sums")
    return out[0] if ref.dim() == 2 else out


__all__ = ["tamper_check_sums", "tamper_check_sums_plain"]
