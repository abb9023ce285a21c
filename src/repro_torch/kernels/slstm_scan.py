"""The sLSTM time scan (each sLSTM layer's recurrence over the sequence):
the CUDA kernel (``csrc/slstm_scan.cu``) and its plain PyTorch version.

pre (T, B, 4d) holds the input pre-activations, r (H, dh, 4dh) the
recurrent weights, dh = d / H; out (T, B, d) the hidden states in pre's
dtype.  State and arithmetic are f32: at step t

    z = pre[t] + rec,  rec = einsum("bhd,hde->bhe", h_prev, r) reshaped to (B, 4d)
    li, lf_raw, zz, oo = the four contiguous quarters of z (d columns each)
    lf = logsigmoid(lf_raw),  m' = max(lf + m, li)
    i = exp(li - m'),  f = exp(lf + m - m')
    c' = f c + i tanh(zz),  n' = f n + i,  h = sigmoid(oo) c' / max(n', 1)

from h = c = n = 0 and m = -1e30.

**The gate layout.**  ``rec`` is reshaped head-major, so column ``c`` of z
takes entry ``e = c % (4 dh)`` of head ``c // (4 dh)``'s R, and the split
into quarters then cuts across heads: head j's R feeds the columns
[j 4dh, (j+1) 4dh).  At H = 4 that is the whole of gate j, for every unit;
at H = 2 head 0 feeds the i and f gates and head 1 the z and o gates; only
at H = 1 does one head feed all four.  The reference kernel's docstring
("gates ordered [i, f, z, o] ... per head") reads otherwise; the math above
is what the reference computes (``repro/kernels/ref.py::
slstm_scan_reference``, ``models/xlstm.py::_slstm_step``), and both
versions here follow the math.

  * :func:`slstm_scan` — launches the step kernel T times on CUDA tensors
    (f32 or bf16 pre, r of pre's dtype, contiguous, any d with d % H == 0).
  * :func:`slstm_scan_plain` — what ``ref.slstm_scan_reference`` computes,
    differentiable by autograd.

``kernels/ops.py`` picks between them by the tensor's device.  The launcher
counts one launch a scan call (T step kernels) in ``build.LAUNCHES``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .flash_attention import DTYPE_CODES

#: the running max's start, the reference kernel's (the model's decode
#: cache starts at -inf; both make f = 0 at t = 0)
M_INIT = -1e30
#: largest d the kernel's shared memory takes: h_prev as (d, 4) f32 beside
#: the kernel's 16 KB reduction buffer, within the 227 KB a block may use
MAX_D = (227 * 1024 - 16 * 1024) // 16


def recurrent(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """h (B, d) f32, r (H, dh, 4dh) -> the recurrent pre-activations (B, 4d)
    f32, head-major (the layout the module docstring describes)."""
    n_heads, dh, _ = r.shape
    b = h.shape[0]
    rec = torch.einsum("bhd,hde->bhe", h.reshape(b, n_heads, dh), r.to(torch.float32))
    return rec.reshape(b, 4 * n_heads * dh)


def slstm_gates(z: torch.Tensor, c: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step's stabilized exponential gating: z (B, 4d) f32 and the state
    (c, n, m) (B, d) f32 -> (h, c', n', m')."""
    li, lf_raw, zz, oo = torch.chunk(z, 4, dim=-1)
    lf = F.logsigmoid(lf_raw)
    m_new = torch.maximum(lf + m, li)
    i = torch.exp(li - m_new)
    f = torch.exp(lf + m - m_new)
    c = f * c + i * torch.tanh(zz)
    n = f * n + i
    h = torch.sigmoid(oo) * c / torch.clamp_min(n, 1.0)
    return h, c, n, m_new


def check_shapes(pre: torch.Tensor, r: torch.Tensor, n_heads: int) -> Tuple[int, int, int]:
    """(T, B, d) of a scan; raises on shapes the scan does not take."""
    if pre.dim() != 3 or pre.shape[-1] % 4 or r.dim() != 3:
        raise ValueError(f"slstm_scan takes pre (T, B, 4d) and r (H, dh, 4dh), got "
                         f"{tuple(pre.shape)} and {tuple(r.shape)}")
    t, b, d4 = pre.shape
    d = d4 // 4
    if n_heads <= 0 or d % n_heads or tuple(r.shape) != (n_heads, d // n_heads,
                                                         4 * (d // n_heads)):
        raise ValueError(f"slstm_scan: r {tuple(r.shape)} is not (H, dh, 4dh) for d {d} "
                         f"and H {n_heads}")
    return t, b, d


def slstm_scan_plain(pre: torch.Tensor, r: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain version of :func:`slstm_scan` (``ref.slstm_scan_reference``):
    pre (T, B, 4d), r (H, dh, 4dh) -> h (T, B, d) in pre's dtype."""
    t, b, d = check_shapes(pre, r, n_heads)
    zeros = torch.zeros((b, d), dtype=torch.float32, device=pre.device)
    h, c, n = zeros, zeros, zeros
    m = torch.full((b, d), M_INIT, dtype=torch.float32, device=pre.device)
    outs = []
    for step in range(t):
        z = pre[step].to(torch.float32) + recurrent(h, r)
        h, c, n, m = slstm_gates(z, c, n, m)
        outs.append(h)
    return torch.stack(outs).to(pre.dtype)


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Launch the scan: pre (T, B, 4d), r (H, dh, 4dh) -> h (T, B, d) in
    pre's dtype; T step kernels on the current stream.  It records no
    gradient: ``ops.slstm_scan`` refuses a tensor that needs one."""
    from .build import load, record_launch
    for x in (pre, r):
        if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
            raise ValueError(f"the slstm_scan kernel takes tensors on the current CUDA "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("the slstm_scan kernel takes contiguous tensors")
    if pre.dtype not in DTYPE_CODES or r.dtype != pre.dtype:
        raise TypeError(f"the slstm_scan kernel takes float32 or bfloat16 pre and r of "
                        f"one dtype, got {pre.dtype} and {r.dtype}")
    t, b, d = check_shapes(pre, r, n_heads)
    if t == 0 or b == 0 or d > MAX_D:
        raise ValueError(f"the slstm_scan kernel takes T, B >= 1 and d <= {MAX_D}; got "
                         f"T {t}, B {b}, d {d}")
    out = torch.empty((t, b, d), dtype=pre.dtype, device=pre.device)
    ws = torch.empty((5, b, d), dtype=torch.float32, device=pre.device)   # h x2, c, n, m
    stream = torch.cuda.current_stream(pre.device).cuda_stream
    err = load("slstm_scan").repro_slstm_scan(
        pre.data_ptr(), r.data_ptr(), out.data_ptr(), ws.data_ptr(), t, b, d, n_heads,
        DTYPE_CODES[pre.dtype], stream)
    record_launch(err, "slstm_scan")
    return out


__all__ = ["M_INIT", "check_shapes", "recurrent", "slstm_gates",
           "slstm_scan", "slstm_scan_plain"]
