"""The sLSTM time scan (each sLSTM layer's recurrence over the sequence):
the CUDA kernels (``csrc/slstm_scan_persistent.cu``, ``csrc/slstm_scan.cu``)
and their plain PyTorch version.

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

  * :func:`slstm_scan` — launches a kernel on CUDA tensors (f32 or bf16
    pre, r of pre's dtype, contiguous) by the route :func:`slstm_route`
    picks: ``persistent`` (``csrc/slstm_scan_persistent.cu``: one
    cooperative launch for all T steps, R's slices and the state on chip,
    one grid barrier a step) where R and the state fit the co-resident grid,
    else ``step`` (``csrc/slstm_scan.cu``: T step kernels; any d with d % H
    == 0 up to :data:`MAX_D`).
  * :func:`slstm_scan_plain` — what ``ref.slstm_scan_reference`` computes,
    differentiable by autograd.

``kernels/ops.py`` picks between them by the tensor's device.  The launcher
counts one launch a scan call in ``build.LAUNCHES`` by route:
``slstm_scan_persistent`` for the persistent kernel, ``slstm_scan`` for the
step kernel (T launches behind one call).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .flash_attention import DTYPE_CODES

#: the running max's start, the reference kernel's (the model's decode
#: cache starts at -inf; both make f = 0 at t = 0)
M_INIT = -1e30
#: largest d the step kernel's shared memory takes: h_prev as (d, 4) f32
#: beside the kernel's 16 KB reduction buffer, within the 227 KB a block may
#: use
MAX_D = (227 * 1024 - 16 * 1024) // 16

#: the routes of :func:`slstm_scan`
PERSISTENT, STEP = "persistent", "step"
#: the persistent kernel's threads a block, units of a column group (one
#: gate of 4 consecutive units: a warp's work), most batch rows (one or two
#: groups of 4) and shared memory a block may use: kThreads, kGroupUnits,
#: kMaxRows and kMaxSmem of csrc/slstm_scan_persistent.cu, which the
#: launcher checks against the library's own on first use
#: (:func:`build.check_constants`)
PERSISTENT_THREADS, GROUP_UNITS, MAX_ROWS, MAX_SMEM = 512, 4, 8, 232448
_PERSISTENT_CONSTANTS = {"kThreads": PERSISTENT_THREADS, "kGroupUnits": GROUP_UNITS,
                         "kMaxRows": MAX_ROWS, "kMaxSmem": MAX_SMEM}


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


def persistent_rows(b: int) -> int:
    """Batch rows the persistent kernel carries: 4, or 8 past 4 rows."""
    return 4 if b <= 4 else 8


def persistent_smem(d: int, dh: int, units: int, rows: int, elt: int, r_elt: int) -> int:
    """Shared memory of a persistent block that owns ``units`` units: R's
    slice as dh rows of ``units + 1`` quads of ``r_elt``-byte entries (one
    pad slot), h of every unit and row in f32, the block's 4 x units x rows
    activated gates, and its pre of two steps (``elt``-byte entries)."""
    return (dh * (units + 1) * 4 * r_elt + d * rows * 4 + 4 * units * rows * 4
            + 2 * 4 * units * rows * elt)


def persistent_plan(b: int, d: int, n_heads: int, elt: int, sms: int, smem: int = MAX_SMEM
                    ) -> Optional[Tuple[int, int, int, int]]:
    """(units a block, blocks, shared memory bytes, bytes of an R entry in
    shared memory) of the persistent kernel on a card of ``sms`` SMs with
    ``smem`` bytes of shared memory a block, or None where it cannot run:
    the fewest units a block (a multiple of :data:`GROUP_UNITS`) that put
    one block on an SM at most, so that the cooperative grid is
    co-resident; R held in f32 where that fits (a bf16 R is then widened
    once, not every step), else in its own dtype; refused past
    :data:`MAX_ROWS` rows, where dh % 4 != 0 (a column group would straddle
    two heads), where a block's (unit, row) pairs outnumber its threads, or
    where R's slice and h exceed the block's shared memory."""
    dh = d // n_heads
    if b > MAX_ROWS or dh % GROUP_UNITS or sms < 1:
        return None
    rows = persistent_rows(b)
    units = -(-(-(-d // sms)) // GROUP_UNITS) * GROUP_UNITS
    if units * rows > PERSISTENT_THREADS:
        return None
    for r_elt in dict.fromkeys((4, elt)):
        need = persistent_smem(d, dh, units, rows, elt, r_elt)
        if need <= smem:
            return units, -(-d // units), need, r_elt
    return None


def slstm_route(pre: torch.Tensor, r: torch.Tensor) -> str:
    """The route for these tensors: :data:`PERSISTENT` where the persistent
    kernel's grid fits the card (:func:`persistent_plan` with the device's SM
    count and shared memory) and pre's and r's bases are 16-byte aligned
    (their quads are 16- or 8-byte copies), else :data:`STEP`."""
    from .build import device_limits
    n_heads = r.shape[0]
    _, b, d = check_shapes(pre, r, n_heads)
    sms, smem = device_limits(pre.device.index)
    plan = persistent_plan(b, d, n_heads, pre.element_size(), sms, smem)
    aligned = r.data_ptr() % 16 == 0 and pre.data_ptr() % 16 == 0
    return PERSISTENT if plan is not None and aligned else STEP


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, n_heads: int, *,
               route: Optional[str] = None) -> torch.Tensor:
    """Launch the scan by :func:`slstm_route` (``route=STEP`` forces the step
    kernel, to time it beside the other): pre (T, B, 4d), r (H, dh, 4dh) ->
    h (T, B, d) in pre's dtype, on the current stream.  It records no
    gradient: ``ops.slstm_scan`` refuses a tensor that needs one.  A launch
    that fails, or a grid that does not fit the card, raises."""
    from .build import check_constants, device_limits, load, record_launch
    for x in (pre, r):
        if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
            raise ValueError(f"the slstm_scan kernels take tensors on the current CUDA "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("the slstm_scan kernels take contiguous tensors")
    if pre.dtype not in DTYPE_CODES or r.dtype != pre.dtype:
        raise TypeError(f"the slstm_scan kernels take float32 or bfloat16 pre and r of "
                        f"one dtype, got {pre.dtype} and {r.dtype}")
    t, b, d = check_shapes(pre, r, n_heads)
    if t == 0 or b == 0:
        raise ValueError(f"the slstm_scan kernels take T, B >= 1; got T {t}, B {b}")
    chosen = slstm_route(pre, r)
    if route not in (None, chosen, STEP):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {STEP!r}")
    out = torch.empty((t, b, d), dtype=pre.dtype, device=pre.device)
    stream = torch.cuda.current_stream(pre.device).cuda_stream
    if (route or chosen) == PERSISTENT:
        lib = load("slstm_scan_persistent")
        check_constants("slstm_scan_persistent", _PERSISTENT_CONSTANTS)
        units, _, _, r_elt = persistent_plan(b, d, n_heads, pre.element_size(),
                                             *device_limits(pre.device.index))
        # h double-buffered as [2][rows][d] f32, then the barrier's counter
        ws = torch.empty((2 * persistent_rows(b) * d + 4,), dtype=torch.float32,
                         device=pre.device)
        err = lib.repro_slstm_scan_persistent(
            pre.data_ptr(), r.data_ptr(), out.data_ptr(), ws.data_ptr(), t, b, d, n_heads,
            units, int(r_elt > pre.element_size()), DTYPE_CODES[pre.dtype], stream)
        record_launch(err, "slstm_scan_persistent")
        return out
    if d > MAX_D:
        raise ValueError(f"the slstm_scan step kernel takes d <= {MAX_D}; got d {d}")
    ws = torch.empty((5, b, d), dtype=torch.float32, device=pre.device)   # h x2, c, n, m
    err = load("slstm_scan").repro_slstm_scan(
        pre.data_ptr(), r.data_ptr(), out.data_ptr(), ws.data_ptr(), t, b, d, n_heads,
        DTYPE_CODES[pre.dtype], stream)
    record_launch(err, "slstm_scan")
    return out


__all__ = ["M_INIT", "MAX_D", "PERSISTENT", "STEP", "check_shapes", "persistent_plan",
           "persistent_rows", "persistent_smem", "recurrent", "slstm_gates", "slstm_route",
           "slstm_scan", "slstm_scan_plain"]
