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

**The backward** (no TPU counterpart: the reference trains by XLA autodiff
of its scan).  With ``save=True`` both kernels also write each step's f32
z = pre + rec (T, B, 4d) and its f32 state h, c, n, m (4, T, B, d);
:func:`slstm_scan_bwd` runs the reverse-time scan from them into dz (T,
B, 4d) f32 by the route :func:`slstm_bwd_route` picks: ``persistent``
(``csrc/slstm_scan_bwd_persistent.cu``: one cooperative launch a reverse
scan, each block's rows of R and its carry on chip, dz exchanged through
L2 behind one grid barrier a step) where :func:`persistent_bwd_plan` fits,
else ``step`` (``csrc/slstm_scan_bwd.cu``, one launch a reverse step);
:func:`slstm_scan_bwd_plain` is the same recurrence in PyTorch.  dpre is dz
cast to pre's dtype; dR is one batched product over the T B rows after the
scan (:func:`recurrent_weight_grad`).  :class:`SlstmScan` wires them into
autograd, with the forward that saves and the reverse scan as arguments:
the kernels on the card, the plain versions in the CPU tests.

``kernels/ops.py`` picks between them by the tensor's device.  The launcher
counts one launch a scan call in ``build.LAUNCHES`` by route:
``slstm_scan_persistent`` for the persistent kernel, ``slstm_scan`` for the
step kernel (T launches behind one call); the backward's
``slstm_scan_bwd_persistent`` and ``slstm_scan_bwd`` (its step route, T
launches behind one call) alike.
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
#: the same four of csrc/slstm_scan_bwd_persistent.cu (its group of 4
#: units is one head's, a warp's work with one range of e)
_BWD_PERSISTENT_CONSTANTS = dict(_PERSISTENT_CONSTANTS)


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
    return slstm_scan_saving_plain(pre, r, n_heads)[0]


def slstm_scan_saving_plain(pre: torch.Tensor, r: torch.Tensor, n_heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`slstm_scan` with ``save=True``: (h (T, B, d)
    in pre's dtype, z (T, B, 4d) f32, the state (4, T, B, d) f32: h, c, n,
    m after each step).  Differentiable by autograd through h alone."""
    t, b, d = check_shapes(pre, r, n_heads)
    zeros = torch.zeros((b, d), dtype=torch.float32, device=pre.device)
    h, c, n = zeros, zeros, zeros
    m = torch.full((b, d), M_INIT, dtype=torch.float32, device=pre.device)
    zs, states = [], []
    for step in range(t):
        z = pre[step].to(torch.float32) + recurrent(h, r)
        h, c, n, m = slstm_gates(z, c, n, m)
        zs.append(z)
        states.append((h, c, n, m))
    with torch.no_grad():
        z_all = torch.stack(zs)
        state = torch.stack([torch.stack(plane) for plane in zip(*states)])
    return torch.stack([st[0] for st in states]).to(pre.dtype), z_all, state


def recurrent_grad(dz: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """dz (B, 4d) f32, r (H, dh, 4dh) -> dz's share of the gradient of the
    previous step's h (B, d) f32: the per-head product with R^T, the
    transpose of :func:`recurrent`."""
    n_heads, dh, e4 = r.shape
    b = dz.shape[0]
    out = torch.einsum("bhe,hke->bhk", dz.reshape(b, n_heads, e4), r.to(torch.float32))
    return out.reshape(b, n_heads * dh)


def recurrent_weight_grad(h: torch.Tensor, dz: torch.Tensor, n_heads: int) -> torch.Tensor:
    """dR (H, dh, 4dh) f32 of a scan: sum over steps t and rows of
    h_{t-1}[:, head]^T dz_t[:, head], with h_{-1} = 0, as one batched product
    over the (T - 1) B rows.  h (T, B, d) is the saved f32 state, dz (T, B,
    4d) the reverse scan's."""
    t, b, d = h.shape
    dh = d // n_heads
    hp = h[:-1].reshape((t - 1) * b, n_heads, dh)
    return torch.einsum("nhk,nhe->hke", hp, dz[1:].reshape((t - 1) * b, n_heads, 4 * dh))


def check_saved(dout: torch.Tensor, r: torch.Tensor, z: torch.Tensor, state: torch.Tensor,
                n_heads: int) -> Tuple[int, int, int]:
    """(T, B, d) of a backward call; raises on saves that are not a scan's."""
    t, b, d = check_shapes(z, r, n_heads)
    if (tuple(dout.shape) != (t, b, d) or tuple(state.shape) != (4, t, b, d)
            or z.dtype != torch.float32 or state.dtype != torch.float32):
        raise ValueError(f"slstm_scan_bwd takes dout (T, B, d), z (T, B, 4d) f32 and the "
                         f"state (4, T, B, d) f32, got {tuple(dout.shape)}, "
                         f"{tuple(z.shape)} {z.dtype}, {tuple(state.shape)} {state.dtype}")
    return t, b, d


def slstm_scan_bwd_plain(dout: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                         state: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Plain version of :func:`slstm_scan_bwd`: the explicit reverse-time
    recurrence (not autograd), as the kernel computes it.  dout (T, B, d),
    r (H, dh, 4dh), z (T, B, 4d) f32 and the state (4, T, B, d) f32 the
    forward saved -> dz (T, B, 4d) f32, the gradient of z = pre + rec.  The
    derivative conventions are the plain version's autograd's: a tie of
    ``torch.maximum`` splits evenly, ``clamp_min(n, 1)`` passes the whole
    gradient where n >= 1, ``logsigmoid'(x) = sigmoid(-x)``; the path
    through the stabilizer m is kept (``max(n, 1)`` breaks m's
    invariance)."""
    t, b, d = check_saved(dout, r, z, state, n_heads)
    f32 = dict(dtype=torch.float32, device=z.device)
    dz = torch.empty((t, b, 4 * d), **f32)
    dc, dn, dm, dh_rec = (torch.zeros((b, d), **f32) for _ in range(4))
    zeros = torch.zeros((b, d), **f32)
    start = (zeros, zeros, torch.full((b, d), M_INIT, **f32))
    for step in reversed(range(t)):
        li, lf_raw, zz, oo = torch.chunk(z[step], 4, dim=-1)
        _, c_t, n_t, m_t = state[:, step]
        c_p, n_p, m_p = state[1:, step - 1] if step else start
        dh = dout[step].to(torch.float32) + dh_rec
        lf = F.logsigmoid(lf_raw)
        tz, so = torch.tanh(zz), torch.sigmoid(oo)
        a = lf + m_p
        ig, fg = torch.exp(li - m_t), torch.exp(a - m_t)
        q = torch.clamp_min(n_t, 1.0)
        dp = dh / q
        dq = -dh * (so * c_t) / (q * q)
        dct = dc + dp * so
        dnt = dn + torch.where(n_t >= 1.0, dq, 0.0)
        doo = dp * c_t * so * (1.0 - so)
        df = dct * c_p + dnt * n_p
        di = dct * tz + dnt
        dzz = dct * ig * (1.0 - tz * tz)
        de_i, de_f = di * ig, df * fg
        dmt = dm - de_i - de_f
        half = 0.5 * dmt
        to_a = torch.where(a < li, 0.0, torch.where(a == li, half, dmt))
        to_li = torch.where(li < a, 0.0, torch.where(a == li, half, dmt))
        da = de_f + to_a
        dz[step] = torch.cat([de_i + to_li, da * torch.sigmoid(-lf_raw), dzz, doo], dim=-1)
        dc, dn, dm = dct * fg, dnt * fg, da
        dh_rec = recurrent_grad(dz[step], r)
    return dz


class SlstmScan(torch.autograd.Function):
    """The scan with its backward: ``SlstmScan.apply(pre, r, n_heads, scan,
    scan_bwd)``.  ``scan(pre, r, n_heads)`` is the forward that saves, ->
    (h, z, state) (:func:`slstm_scan` with ``save=True`` on the card,
    :func:`slstm_scan_saving_plain`); ``scan_bwd(dout, r, z, state,
    n_heads)`` the reverse scan -> dz (:func:`slstm_scan_bwd`,
    :func:`slstm_scan_bwd_plain`).  The backward casts dz to pre's dtype
    for dpre and computes dR by :func:`recurrent_weight_grad` in f32, cast
    to r's dtype.  z and the state go through ``save_for_backward``, so a
    checkpointed layer drops them until its recomputation."""

    @staticmethod
    def forward(ctx, pre, r, n_heads, scan, scan_bwd):
        out, z, state = scan(pre, r, n_heads)
        ctx.save_for_backward(r, z, state)
        ctx.n_heads, ctx.scan_bwd, ctx.pre_dtype = n_heads, scan_bwd, pre.dtype
        return out

    @staticmethod
    def backward(ctx, dout):
        r, z, state = ctx.saved_tensors
        dz = ctx.scan_bwd(dout.contiguous(), r, z, state, ctx.n_heads)
        dpre = dz.to(ctx.pre_dtype) if ctx.needs_input_grad[0] else None
        dr = (recurrent_weight_grad(state[0], dz, ctx.n_heads).to(r.dtype)
              if ctx.needs_input_grad[1] else None)
        return dpre, dr, None, None, None


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


def _plan(b: int, d: int, n_heads: int, elt: int, sms: int, smem: int, need
          ) -> Optional[Tuple[int, int, int, int]]:
    """What both persistent kernels' plans share: the fewest units a block (a
    multiple of :data:`GROUP_UNITS`) that put one block on an SM at most, so
    that the cooperative grid is co-resident; R held in f32 where ``need(dh,
    units, rows, r_elt)`` bytes fit ``smem`` (a bf16 R is then widened once,
    not every step), else in its own dtype; refused past :data:`MAX_ROWS`
    rows, where dh % 4 != 0 (a group of 4 units would straddle two heads) or
    where a block's (unit, row) pairs outnumber its threads."""
    dh = d // n_heads
    if b > MAX_ROWS or dh % GROUP_UNITS or sms < 1:
        return None
    rows = persistent_rows(b)
    units = -(-(-(-d // sms)) // GROUP_UNITS) * GROUP_UNITS
    if units * rows > PERSISTENT_THREADS:
        return None
    for r_elt in dict.fromkeys((4, elt)):
        size = need(dh, units, rows, r_elt)
        if size <= smem:
            return units, -(-d // units), size, r_elt
    return None


def persistent_plan(b: int, d: int, n_heads: int, elt: int, sms: int, smem: int = MAX_SMEM
                    ) -> Optional[Tuple[int, int, int, int]]:
    """(units a block, blocks, shared memory bytes, bytes of an R entry in
    shared memory) of the persistent kernel on a card of ``sms`` SMs with
    ``smem`` bytes of shared memory a block, or None where it cannot run
    (:func:`_plan`), or where R's slice and h exceed the block's shared
    memory (:func:`persistent_smem`)."""
    return _plan(b, d, n_heads, elt, sms, smem, lambda dh, units, rows, r_elt:
                 persistent_smem(d, dh, units, rows, elt, r_elt))


def persistent_bwd_span(d: int, dh: int, units: int) -> int:
    """The most heads a block of the persistent backward spans: its units
    [u0, u0 + units) need dz's 4dh columns of each head they fall in (two
    where dh % units != 0 puts a head boundary inside a block)."""
    return max((min(u0 + units, d) - 1) // dh - u0 // dh + 1 for u0 in range(0, d, units))


def persistent_bwd_smem(dh: int, units: int, rows: int, span: int, r_elt: int) -> int:
    """Shared memory of a persistent backward block that owns ``units``
    units: their rows of R (units x 4dh entries of ``r_elt`` bytes), dz of
    the ``span`` heads they fall in (rows x 4dh f32 a head), the warps' sums
    (a group of 4 units and one of 16 / groups ranges of e a warp, rows x 4
    sums each), and each (row, unit)'s inputs of two steps (z and the state
    c, n, m: 7 f32)."""
    groups = units // GROUP_UNITS
    splits = max(1, PERSISTENT_THREADS // 32 // groups)
    return (units * 4 * dh * r_elt + span * rows * 4 * dh * 4
            + groups * splits * rows * GROUP_UNITS * 4 + 2 * 7 * units * rows * 4)


def persistent_bwd_plan(b: int, d: int, n_heads: int, elt: int, sms: int,
                        smem: int = MAX_SMEM) -> Optional[Tuple[int, int, int, int]]:
    """(units a block, blocks, shared memory bytes, bytes of an R entry in
    shared memory) of the persistent backward on a card of ``sms`` SMs with
    ``smem`` bytes of shared memory a block, or None where it cannot run:
    the forward's grid (:func:`_plan`), refused where R's rows and dz's
    slice exceed the block's shared memory (:func:`persistent_bwd_smem`)."""
    return _plan(b, d, n_heads, elt, sms, smem, lambda dh, units, rows, r_elt:
                 persistent_bwd_smem(dh, units, rows, persistent_bwd_span(d, dh, units),
                                     r_elt))


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


def slstm_bwd_route(dout: torch.Tensor, r: torch.Tensor) -> str:
    """The backward's route for these tensors: :data:`PERSISTENT` where the
    persistent backward's grid fits the card (:func:`persistent_bwd_plan`
    with the device's SM count and shared memory) and r's base is 16-byte
    aligned (its rows are read as quads), else :data:`STEP`."""
    from .build import device_limits
    n_heads = r.shape[0]
    _, b, d = dout.shape
    sms, smem = device_limits(dout.device.index)
    plan = persistent_bwd_plan(b, d, n_heads, dout.element_size(), sms, smem)
    return PERSISTENT if plan is not None and r.data_ptr() % 16 == 0 else STEP


def _check_card(*tensors: torch.Tensor) -> None:
    for x in tensors:
        if x.device.type != "cuda" or x.device.index != torch.cuda.current_device():
            raise ValueError(f"the slstm_scan kernels take tensors on the current CUDA "
                             f"device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError("the slstm_scan kernels take contiguous tensors")


def _check_dtypes(x: torch.Tensor, r: torch.Tensor) -> None:
    if x.dtype not in DTYPE_CODES or r.dtype != x.dtype:
        raise TypeError(f"the slstm_scan kernels take float32 or bfloat16 pre and r of "
                        f"one dtype, got {x.dtype} and {r.dtype}")


def slstm_scan(pre: torch.Tensor, r: torch.Tensor, n_heads: int, *,
               route: Optional[str] = None, save: bool = False):
    """Launch the scan by :func:`slstm_route` (``route=STEP`` forces the step
    kernel, to time it beside the other): pre (T, B, 4d), r (H, dh, 4dh) ->
    h (T, B, d) in pre's dtype, on the current stream.  With ``save`` it
    returns (h, z (T, B, 4d) f32, state (4, T, B, d) f32), what
    :func:`slstm_scan_bwd` reads; it records no gradient itself
    (:class:`SlstmScan` does).  A launch that fails, or a grid that does not
    fit the card, raises."""
    from .build import check_constants, device_limits, load, record_launch
    _check_card(pre, r)
    _check_dtypes(pre, r)
    t, b, d = check_shapes(pre, r, n_heads)
    if t == 0 or b == 0:
        raise ValueError(f"the slstm_scan kernels take T, B >= 1; got T {t}, B {b}")
    chosen = slstm_route(pre, r)
    if route not in (None, chosen, STEP):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {STEP!r}")
    out = torch.empty((t, b, d), dtype=pre.dtype, device=pre.device)
    z = state = None
    if save:
        z = torch.empty((t, b, 4 * d), dtype=torch.float32, device=pre.device)
        state = torch.empty((4, t, b, d), dtype=torch.float32, device=pre.device)
    saves = (0 if z is None else z.data_ptr(), 0 if state is None else state.data_ptr())
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
            pre.data_ptr(), r.data_ptr(), out.data_ptr(), ws.data_ptr(), *saves, t, b, d,
            n_heads, units, int(r_elt > pre.element_size()), DTYPE_CODES[pre.dtype], stream)
        record_launch(err, "slstm_scan_persistent")
        return (out, z, state) if save else out
    if d > MAX_D:
        raise ValueError(f"the slstm_scan step kernel takes d <= {MAX_D}; got d {d}")
    ws = torch.empty((5, b, d), dtype=torch.float32, device=pre.device)   # h x2, c, n, m
    err = load("slstm_scan").repro_slstm_scan(
        pre.data_ptr(), r.data_ptr(), out.data_ptr(), ws.data_ptr(), *saves, t, b, d,
        n_heads, DTYPE_CODES[pre.dtype], stream)
    record_launch(err, "slstm_scan")
    return (out, z, state) if save else out


def slstm_scan_saving(pre: torch.Tensor, r: torch.Tensor, n_heads: int):
    """:func:`slstm_scan` with ``save=True`` on the route it picks: (h, z,
    state), the forward :class:`SlstmScan` runs on the card."""
    return slstm_scan(pre, r, n_heads, save=True)


def slstm_scan_bwd(dout: torch.Tensor, r: torch.Tensor, z: torch.Tensor,
                   state: torch.Tensor, n_heads: int, *, route: Optional[str] = None
                   ) -> torch.Tensor:
    """Launch the reverse-time scan on the current stream by
    :func:`slstm_bwd_route` (``route=STEP`` forces the step kernel, to time
    it beside the other): dout (T, B, d) and r (H, dh, 4dh) in one dtype
    (f32 or bf16), the forward's saves z (T, B, 4d) and state (4, T, B, d)
    f32 -> dz (T, B, 4d) f32.  Any (T, B, d, H) the forward takes; anything
    else raises, as do an unknown route, a launch that fails and a grid that
    does not fit the card."""
    from .build import check_constants, device_limits, load, record_launch
    if route not in (None, PERSISTENT, STEP):
        raise ValueError(f"slstm_scan_bwd: unknown route {route!r}")
    _check_card(dout, r, z, state)
    _check_dtypes(dout, r)
    t, b, d = check_saved(dout, r, z, state, n_heads)
    if t == 0 or b == 0:
        raise ValueError(f"slstm_scan_bwd takes T, B >= 1; got T {t}, B {b}")
    chosen = slstm_bwd_route(dout, r)
    if route not in (None, chosen, STEP):
        raise ValueError(f"route {route!r}: these tensors take {chosen!r} or {STEP!r}")
    dz = torch.empty((t, b, 4 * d), dtype=torch.float32, device=z.device)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    if (route or chosen) == PERSISTENT:
        lib = load("slstm_scan_bwd_persistent")
        check_constants("slstm_scan_bwd_persistent", _BWD_PERSISTENT_CONSTANTS)
        units, _, _, r_elt = persistent_bwd_plan(b, d, n_heads, dout.element_size(),
                                                 *device_limits(z.device.index))
        arrived = torch.empty((1,), dtype=torch.int32, device=z.device)   # the barrier's
        err = lib.repro_slstm_scan_bwd_persistent(
            dout.data_ptr(), r.data_ptr(), z.data_ptr(), state.data_ptr(), dz.data_ptr(),
            arrived.data_ptr(), t, b, d, n_heads, units, int(r_elt > dout.element_size()),
            DTYPE_CODES[dout.dtype], stream)
        record_launch(err, "slstm_scan_bwd_persistent")
        return dz
    carry = torch.empty((3, b, d), dtype=torch.float32, device=z.device)   # dc, dn, dm
    err = load("slstm_scan_bwd").repro_slstm_scan_bwd(
        dout.data_ptr(), r.data_ptr(), z.data_ptr(), state.data_ptr(), dz.data_ptr(),
        carry.data_ptr(), t, b, d, n_heads, DTYPE_CODES[dout.dtype], stream)
    record_launch(err, "slstm_scan_bwd")
    return dz


__all__ = ["M_INIT", "MAX_D", "PERSISTENT", "STEP", "SlstmScan", "check_saved",
           "check_shapes", "persistent_bwd_plan", "persistent_bwd_smem",
           "persistent_bwd_span", "persistent_plan", "persistent_rows", "persistent_smem",
           "recurrent", "recurrent_grad", "recurrent_weight_grad",
           "slstm_bwd_route", "slstm_gates", "slstm_route", "slstm_scan", "slstm_scan_bwd",
           "slstm_scan_bwd_plain", "slstm_scan_plain", "slstm_scan_saving",
           "slstm_scan_saving_plain"]
