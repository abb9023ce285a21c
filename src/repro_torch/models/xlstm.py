"""xLSTM mixers: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, recurrent scan), the reference's ``repro/models/xlstm.py``.

The mLSTM's sequence path computes each chunk's stabilised exponential
gating as a masked quadratic form and carries the ``(C_hat, n_hat, m)``
matrix memory across chunks (log-stabilised, ``C_hat = C * exp(-m)``); its
einsums are plain PyTorch, as the reference leaves them to XLA.  The
sLSTM's time scan runs through :func:`kernels.ops.slstm_scan` (B7 on the
card).  Decode is the O(1) recurrence of the xLSTM paper
[arXiv:2405.04517] for both, in plain PyTorch.

The mixers are ``nn.Module``\\ s whose parameter names are the reference
pytree's paths (``up.w``, ``wq.w``, ``w_if.b``, ``r``, ...), so that
``convert.py`` carries them unchanged.  A decode cache is a dict of f32
tensors, the reference's ``init_*_cache``; ``decode`` writes the new state
into it in place and returns the output.

:class:`StackedMLSTM` and :class:`StackedSLSTM` are the cluster-stacked
forms (n slots, the same parameters with a leading slot axis) the batched
round trains: x (n, B, S, d_model).  Their products run one a slot
(``StackedLinear``); the mLSTM's chunked einsums, which hold no weights,
run over the folded n * B batch, and the sLSTM's scan (B7, forward and
backward) once a slot, each slot with its own R.

Under a model axis m > 1 that divides the heads (``par``,
``models/parallel.py``) an mLSTM holds H/m heads: ``up``'s x_inner
section whole (``wq``, ``wk`` and ``wv`` read every column of it; its
gradient summed over ``model`` by ``parallel.shared_sections``) and its z
section by heads, ``wq``/``wk``/``wv`` heads-out, ``w_if``'s [i, f]
sections by heads, ``out_norm`` by heads with its mean of squares
all-reduced (``blocks.rms_norm``), ``down`` row-parallel; its decode
state holds the rank's heads.  Where m does not divide the heads
(xLSTM-1.3B's 4 at 16) the mLSTM is whole on each model rank.  The sLSTM is
always whole on each model rank: B7's gate layout feeds gate j of every
unit from head j's R (``kernels/slstm_scan.py``), so its recurrence couples
every head and no split of heads computes it.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.slstm_scan import recurrent, slstm_gates
from .blocks import Linear, RMSNorm, StackedLinear, StackedRMSNorm
from .parallel import Layout, enter, leave, mark_by_rule, optional, shared_sections

Cache = Dict[str, torch.Tensor]
STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class XLSTMConfig(NamedTuple):
    d_model: int
    n_heads: int = 4
    proj_factor: int = 2
    chunk: int = 256
    # dtype of the (C, n) matrix-memory carries and the big gated einsums'
    # operands; exponents and stabilisers stay f32 (``mlstm_bf16_state``)
    state_dtype: str = "float32"

    @property
    def d_inner(self) -> int:
        return self.proj_factor * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _as_state(x: torch.Tensor, sdt: torch.dtype) -> torch.Tensor:
    """x rounded to the state dtype and held in f32: the operand of one of
    the reference's ``einsum(..., preferred_element_type=f32)`` (bf16
    products are exact in f32)."""
    return x if sdt == torch.float32 else x.to(sdt).to(torch.float32)


def _mlstm_chunk(carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                 q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lf: torch.Tensor,
                 li: torch.Tensor, scale: float, sdt: torch.dtype):
    """One chunk.  carry: (C_hat (B,H,D,D), n_hat (B,H,D), m (B,H)), the
    first two holding ``sdt`` values in f32; q, k, v (B,Q,H,D) f32; lf, li
    (B,Q,H).  Returns (carry', h (B,Q,H,D) f32)."""
    C_in, n_in, m_in = carry
    qn = q.shape[1]
    Lf = torch.cumsum(lf, dim=1)                                  # (B,Q,H)
    # intra-chunk log weights D[t,s] = Lf_t - Lf_s + li_s  (s <= t)
    dmat = Lf[:, :, None, :] - Lf[:, None, :, :] + li[:, None, :, :]
    causal = torch.ones((qn, qn), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    dmat = torch.where(causal, dmat, float("-inf"))
    a = m_in[:, None, :] + Lf                                     # (B,Q,H) inter log-scale
    m_t = torch.maximum(a, dmat.amax(dim=2))                      # (B,Q,H)
    w = torch.exp(dmat - m_t[:, :, None, :])                      # (B,Q,Q,H)
    qs, ks, vs = (_as_state(x, sdt) for x in (q, k, v))
    qk = torch.einsum("bqhd,bshd->bqsh", qs, ks) * scale
    gated = _as_state(w * qk, sdt)
    intra = torch.einsum("bqsh,bshd->bqhd", gated, vs)
    inter_scale = torch.exp(a - m_t)                              # (B,Q,H)
    inter = torch.einsum("bqhd,bhde->bqhe", qs, C_in) * inter_scale[..., None]
    num = intra + inter
    denom_intra = gated.sum(dim=2)                                # (B,Q,H)
    denom_inter = torch.einsum("bqhd,bhd->bqh", qs, n_in) * inter_scale
    denom = torch.maximum((denom_intra + denom_inter).abs(), torch.exp(-m_t))
    h = num / denom[..., None]
    # chunk-end state update
    end_w = Lf[:, -1:, :] - Lf + li                               # (B,Q,H)
    m_out = torch.maximum(m_in + Lf[:, -1, :], end_w.amax(dim=1))
    kv_w = _as_state(torch.exp(end_w - m_out[:, None, :]), sdt)  # (B,Q,H)
    decay_out = torch.exp(m_in + Lf[:, -1, :] - m_out)
    # the reference's ks * scale takes the scale in ks's dtype (a weak scalar)
    ks_scaled = _as_state(ks * float(torch.tensor(scale, dtype=sdt)), sdt)
    C_out = _as_state(C_in * decay_out[..., None, None]
                      + torch.einsum("bqhd,bqhe->bhde", kv_w[..., None] * ks_scaled, vs), sdt)
    n_out = _as_state(n_in * decay_out[..., None]
                      + torch.einsum("bqh,bqhd->bhd", kv_w, ks_scaled), sdt)
    return (C_out, n_out, m_out), h


def init_mlstm_cache(batch: int, cfg: XLSTMConfig, device=None, n: int = 1,
                     parts: int = 1) -> Cache:
    """Zeroed decode state of ``n`` layers: C (n, B, H, D, D), n (n, B, H,
    D), m (n, B, H) = -inf, all f32 (index 0 for one layer); with ``parts``
    (the model axis the heads split over) a rank's H / parts heads."""
    h, pd = cfg.n_heads // parts, cfg.head_dim
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((n, batch, h, pd, pd), **kw),
            "n": torch.zeros((n, batch, h, pd), **kw),
            "m": torch.full((n, batch, h), float("-inf"), **kw)}


def _mlstm_parts(mixer: nn.Module, cfg: XLSTMConfig, par) -> None:
    """The mixer's view, its local heads ``h`` and inner width ``di``, and
    its layout over ``model`` (see the module docstring)."""
    mixer.par = par = optional(par).over(cfg.n_heads)
    m = par.model_size
    mixer.h, mixer.di = cfg.n_heads // m, cfg.d_inner // m


def _mark_mlstm(mixer: nn.Module, cfg: XLSTMConfig) -> None:
    """The heads over ``model``: the spec's ``wq``/``wk``/``wv`` (heads-out)
    and ``down`` (heads-in), but ``up`` by sections [x_inner whole, z by
    heads] (the spec cuts across them), ``w_if`` and its bias [i, f] by
    heads (the spec cuts ``w_if`` across, replicates the bias) and
    ``out_norm`` by heads (replicated in the spec)."""
    par = mixer.par
    m, r, di, h = par.model_size, par.model_rank, cfg.d_inner, cfg.n_heads
    gates = Layout(-1, m, r, ((h, True), (h, True)))
    mark_by_rule(mixer, par, departures={
        "up.w": Layout(-1, m, r, ((di, False), (di, True))), "w_if.w": gates,
        "w_if.b": gates, "out_norm.scale": Layout(-1, m, r)})


class MLSTM(nn.Module):
    """The mLSTM mixer: ``up`` to [x_inner, z gate], ``wq, wk, wv`` over
    x_inner, input/forget gate pre-activations ``w_if`` (+ bias), the
    output norm and ``down``; with ``par`` this rank's heads (see the module
    docstring)."""

    def __init__(self, cfg: XLSTMConfig, *, dtype: torch.dtype = torch.float32, device=None,
                 par=None):
        super().__init__()
        self.cfg = cfg
        _mlstm_parts(self, cfg, par)
        di, dl = cfg.d_inner, self.di
        kw = dict(dtype=dtype, device=device)
        self.up = Linear(cfg.d_model, di + dl, **kw)
        self.wq = Linear(di, dl, **kw)
        self.wk = Linear(di, dl, **kw)
        self.wv = Linear(di, dl, **kw)
        self.w_if = Linear(di, 2 * self.h, bias=True, **kw)
        self.out_norm = RMSNorm(dl, par=self.par, **kw)
        self.down = Linear(dl, cfg.d_model, **kw)
        _mark_mlstm(self, cfg)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``mlstm_init``, drawn in its order."""
        for lin in (self.up, self.wq, self.wk, self.wv, self.w_if):
            lin.reset_parameters(generator)
        self.out_norm.reset_parameters()
        self.down.reset_parameters(generator)

    def _project(self, x: torch.Tensor):
        """x (..., d_model) -> (q, k, v (..., H, D) f32, li, lf (..., H) f32,
        the z gate in x's dtype); the rank's heads under ``par``."""
        cfg = self.cfg
        xi, z = torch.split(self.up(x, shared_sections(self.up.w, self.par.model_group)),
                            [cfg.d_inner, self.di], dim=-1)
        heads = x.shape[:-1] + (self.h, cfg.head_dim)
        q, k, v = (lin(xi).reshape(heads).to(torch.float32) for lin in (self.wq, self.wk,
                                                                          self.wv))
        li, lf_raw = torch.chunk(self.w_if(xi).to(torch.float32), 2, dim=-1)
        return q, k, v, li, F.logsigmoid(lf_raw), z

    def _out(self, hval: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return leave(self.down(self.out_norm(hval) * F.silu(z)), self.par)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``mlstm_forward``: x (..., S, d_model) -> (..., S,
        d_model), chunk by chunk, the leading axes folded into one batch.
        S must be a multiple of ``cfg.chunk`` when it exceeds it (the
        reference asserts; padding would change the result)."""
        cfg = self.cfg
        lead, s = x.shape[:-2], x.shape[-2]
        q, k, v, li, lf, z = self._project(enter(x, self.par))
        qn = min(cfg.chunk, s)
        if s % qn:
            raise ValueError(f"mlstm_forward: the sequence length {s} is not a multiple of "
                             f"the chunk {cfg.chunk}")
        q, k, v, li, lf = (t.reshape((-1, s) + t.shape[len(lead) + 1:])
                           for t in (q, k, v, li, lf))
        b = q.shape[0]
        sdt = STATE_DTYPES[cfg.state_dtype]
        h, pd = self.h, cfg.head_dim
        carry = (torch.zeros((b, h, pd, pd), dtype=torch.float32, device=x.device),
                 torch.zeros((b, h, pd), dtype=torch.float32, device=x.device),
                 torch.full((b, h), float("-inf"), dtype=torch.float32, device=x.device))
        scale = 1.0 / math.sqrt(pd)
        hs = []
        for lo in range(0, s, qn):
            part = slice(lo, lo + qn)
            carry, hc = _mlstm_chunk(carry, q[:, part], k[:, part], v[:, part], lf[:, part],
                                     li[:, part], scale, sdt)
            hs.append(hc)
        out = torch.cat(hs, dim=1).reshape(lead + (s, self.di)).to(x.dtype)
        return self._out(out, z)

    def decode(self, x: torch.Tensor, cache: Cache) -> torch.Tensor:
        """The reference's ``mlstm_decode``: x (B, 1, d_model) -> (B, 1,
        d_model); the cache {"C", "n", "m"} of this layer is updated in
        place."""
        cfg = self.cfg
        b = x.shape[0]
        hh, pd = self.h, cfg.head_dim
        q, k, v, li, lf, z = self._project(x[:, 0])
        ks = k * (1.0 / math.sqrt(pd))
        m_prev = cache["m"]
        m_new = torch.maximum(m_prev + lf, li)
        decay = torch.exp(m_prev + lf - m_new)
        inject = torch.exp(li - m_new)
        kin = inject[..., None] * ks
        C = cache["C"].view(b * hh, pd, pd)
        C.mul_(decay.reshape(-1, 1, 1)).baddbmm_(kin.reshape(-1, pd, 1), v.reshape(-1, 1, pd))
        n = cache["n"].mul_(decay[..., None]).add_(kin)
        m_prev.copy_(m_new)
        num = torch.bmm(q.reshape(-1, 1, pd), C).reshape(b, hh, pd)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n).abs(), torch.exp(-m_new))
        hval = (num / den[..., None]).reshape(b, self.di).to(x.dtype)
        return self._out(hval, z)[:, None, :]


class StackedMLSTM(nn.Module):
    """n slots' :class:`MLSTM` (the same parameters, each with a leading
    slot axis): x (n, B, S, d_model).  The projections run a product a slot;
    the chunked einsums over the folded n * B batch (:meth:`MLSTM.forward`
    folds the leading axes); ``par`` as :class:`MLSTM`'s."""

    def __init__(self, cfg: XLSTMConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None, par=None):
        super().__init__()
        self.cfg = cfg
        _mlstm_parts(self, cfg, par)
        di, dl = cfg.d_inner, self.di
        kw = dict(dtype=dtype, device=device)
        self.up = StackedLinear(n, cfg.d_model, di + dl, **kw)
        self.wq = StackedLinear(n, di, dl, **kw)
        self.wk = StackedLinear(n, di, dl, **kw)
        self.wv = StackedLinear(n, di, dl, **kw)
        self.w_if = StackedLinear(n, di, 2 * self.h, bias=True, **kw)
        self.out_norm = StackedRMSNorm(n, dl, par=self.par, **kw)
        self.down = StackedLinear(n, dl, cfg.d_model, **kw)
        _mark_mlstm(self, cfg)

    _project = MLSTM._project
    _out = MLSTM._out
    forward = MLSTM.forward


def mlstm_forward_reference(mixer: MLSTM, x: torch.Tensor) -> torch.Tensor:
    """Step-by-step recurrent oracle of :meth:`MLSTM.forward` (tests only)."""
    cache = {k: v[0] for k, v in init_mlstm_cache(x.shape[0], mixer.cfg, x.device).items()}
    return torch.cat([mixer.decode(x[:, t:t + 1], cache) for t in range(x.shape[1])], dim=1)


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, per-head recurrent weights)
# ---------------------------------------------------------------------------

def init_slstm_cache(batch: int, cfg: XLSTMConfig, device=None, n: int = 1) -> Cache:
    """Zeroed decode state of ``n`` layers: c, n, h (n, B, d) and m = -inf,
    all f32."""
    shape = (n, batch, cfg.d_model)
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **kw), "n": torch.zeros(shape, **kw),
            "h": torch.zeros(shape, **kw), "m": torch.full(shape, float("-inf"), **kw)}


def _slstm_step(r: torch.Tensor, pre_x: torch.Tensor, state: Cache) -> Cache:
    """One step of the recurrence from ``state`` {"c", "n", "h", "m"} (B,
    d) f32: pre_x (B, 4d) -> the new state."""
    z = pre_x.to(torch.float32) + recurrent(state["h"], r)
    h, c, n, m = slstm_gates(z, state["c"], state["n"], state["m"])
    return {"c": c, "n": n, "h": h, "m": m}


class SLSTM(nn.Module):
    """The sLSTM mixer: input pre-activations ``w_in`` (+ bias) for the
    gates [i, f, z, o], the recurrent weights ``r`` (H, dh, 4dh), the output
    norm and ``down``."""

    def __init__(self, cfg: XLSTMConfig, *, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        kw = dict(dtype=dtype, device=device)
        self.w_in = Linear(d, 4 * d, bias=True, **kw)
        self.r = nn.Parameter(torch.empty((h, dh, 4 * dh), **kw))
        self.out_norm = RMSNorm(d, **kw)
        self.down = Linear(d, d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``slstm_init``: r ~ N(0, 1) / sqrt(dh)."""
        self.w_in.reset_parameters(generator)
        r = torch.randn(self.r.shape, generator=generator, device=generator.device)
        self.r.copy_(r / math.sqrt(self.r.shape[1]))
        self.out_norm.reset_parameters()
        self.down.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``slstm_forward``: x (B, S, d) -> (B, S, d), the
        scan through B7 (the reference's ``slstm_unroll`` only unrolls this
        same scan, so the port has no such option)."""
        pre = self.w_in(x)                                        # (B,S,4d)
        hs = ops.slstm_scan(pre.transpose(0, 1), self.r, self.cfg.n_heads)
        return self.down(self.out_norm(hs.transpose(0, 1).to(x.dtype)))

    def decode(self, x: torch.Tensor, cache: Cache) -> torch.Tensor:
        """The reference's ``slstm_decode``: x (B, 1, d) -> (B, 1, d); the
        cache {"c", "n", "h", "m"} of this layer is updated in place."""
        new = _slstm_step(self.r, self.w_in(x[:, 0]), cache)
        for name, value in new.items():
            cache[name].copy_(value)
        return self.down(self.out_norm(new["h"].to(x.dtype)))[:, None, :]


class StackedSLSTM(nn.Module):
    """n slots' :class:`SLSTM`: x (n, B, S, d), r (n, H, dh, 4dh).  The
    projections run a product a slot, the norm over all slots, and the scan
    (B7, forward and backward) once a slot, each with its own R, as B4 runs
    once a slot."""

    def __init__(self, cfg: XLSTMConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        kw = dict(dtype=dtype, device=device)
        self.w_in = StackedLinear(n, d, 4 * d, bias=True, **kw)
        self.r = nn.Parameter(torch.zeros((n, h, dh, 4 * dh), **kw))
        self.out_norm = StackedRMSNorm(n, d, **kw)
        self.down = StackedLinear(n, d, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # w_in's product and the scan a slot, each slot's pre-activations a
        # tensor of their own: the gradient reaching w_in's bias then lies
        # in memory as the plain mixer's does, and its sum over (B, S)
        # rounds alike (a slice of one stacked (n, B, S, 4d) gradient sums
        # in another order)
        hs = torch.stack([ops.slstm_scan((xi @ w + b).transpose(0, 1), r, self.cfg.n_heads)
                          for xi, w, b, r in zip(x, self.w_in.w, self.w_in.b, self.r)])
        return self.down(self.out_norm(hs.transpose(1, 2).to(x.dtype)))   # hs (n,S,B,d)


__all__ = ["MLSTM", "SLSTM", "StackedMLSTM", "StackedSLSTM", "XLSTMConfig",
           "init_mlstm_cache", "init_slstm_cache", "mlstm_forward_reference"]
