"""PyTorch/CUDA port of the Pigeon-SL reproduction.

``src/repro`` (JAX) is the reference; this package mirrors its file layout
and public names, imports ``torch`` and numpy only, and never imports
``jax`` or ``repro``.

Device policy: every public entry point takes ``device``.  ``None`` means
the CUDA card and raises when there is none — the port never carries on
quietly on the CPU.  The CPU runs only when the caller asks for it
(``device="cpu"``), as the parity tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on (see the module docstring).

    On a CUDA device this also switches TF32 off for cuDNN convolutions and
    matrix products: validation losses are compared across clusters and a
    quantization scale depends on a row's max, so the CNN runs in full f32
    (cuDNN's f32 convolutions default to TF32)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} requested but CUDA is not "
                               f"available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device={device!r}: repro_torch runs on 'cuda' or "
                         f"'cpu'")
    return dev


__all__ = ["DeviceLike", "resolve_device"]
