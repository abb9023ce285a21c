"""Mamba2 (SSD), the reference's ``repro/models/ssm.py``: a chunked
selective state-space mixer.

Training and prefill run the chunked SSD algorithm: within a chunk the
recurrence is a masked quadratic form, across chunks one loop carries the
(B, H, P, N) recurrent state (the reference's ``lax.scan``).  Live memory is
O(chunk^2).  Decode is the O(1) recurrence ``h = h * exp(dt A) + dt (B x)``.
The SSD runs in plain PyTorch, as the reference leaves it to XLA: it holds no
Pallas kernel.

Dtypes follow the reference: the projections and the causal depthwise
convolution run in the model's dtype; dt (softplus in f32), A, x, B, C and
the state are f32; the output goes back to the model's dtype before
``out_norm``.  The chunk must divide the sequence (the reference asserts).

:class:`Mamba2`'s parameter names are the reference pytree's paths
(``in_proj.w``, ``conv_w``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``,
``out_norm.scale``, ``out_proj.w``), so that ``convert.py`` carries them
unchanged.  :func:`mamba2_forward` and :func:`mamba2_decode` are functions
of the weights (:class:`Mamba2Weights`), which :class:`Mamba2` and the
cluster-stacked :class:`StackedMamba2` (a call a slot, on views of its
stacked weights) both call.  A decode cache is {"state" (B, H, P, N) f32,
"conv" (B, K-1, C) in the model's dtype}; ``decode`` writes it in place.

Under a model axis m > 1 that divides the SSD heads (``par``,
``models/parallel.py``) a rank holds H/m heads: ``in_proj``'s z, x and dt
sections split by heads and its B and C sections whole (a sectioned
``parallel.Layout``: the reference's spec cuts the concatenated columns
straight across the sections), the convolution over the rank's x channels
and the whole B and C (``conv_w``/``conv_b`` sectioned alike), ``A_log``,
``dt_bias``, ``D`` and ``out_norm`` by heads, ``out_proj`` row-parallel.
The whole B and C sections take their gradient summed over ``model``
(``parallel.shared_sections``), ``out_norm``'s mean of squares is the
ranks' sums all-reduced (``blocks.rms_norm``), and the output leaves with
one all-reduce.  The decode cache holds the rank's heads and its
convolution channels.  The functions read the local widths off the
weights.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Linear, RMSNorm, StackedLinear, StackedRMSNorm, rms_norm
from .parallel import SINGLE, Layout, enter, leave, mark_by_rule, optional, shared_sections

Cache = Dict[str, torch.Tensor]


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


class Mamba2Weights(NamedTuple):
    """One layer's Mamba2 parameters."""
    in_proj: torch.Tensor        # (d_model, 2 di + 2 N + H): [z, x, B, C, dt]
    conv_w: torch.Tensor         # (K, C)
    conv_b: torch.Tensor         # (C,)
    A_log: torch.Tensor          # (H,): A = -exp(A_log)
    dt_bias: torch.Tensor        # (H,)
    D: torch.Tensor              # (H,)
    out_norm: torch.Tensor       # (di,)
    out_proj: torch.Tensor       # (di, d_model)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), exact for
    large x too."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _depthwise_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution over the sequence, then SiLU.  xbc (B,
    S, C); w (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = 0
    for i in range(k):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def _ssd_chunk(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor):
    """One SSD chunk.  state (B, H, P, N); x (B, Q, H, P), dt (B, Q, H), bm
    and cm (B, Q, N), a (H,), all f32.  Returns (the state after the
    chunk, y (B, Q, H, P))."""
    q = x.shape[1]
    cum = torch.cumsum(dt * a, dim=1)                                 # (B,Q,H), negative
    diff = cum[:, :, None, :] - cum[:, None, :, :]                    # (B,Q,Q,H)
    # mask BEFORE exp: above the diagonal the differences are positive and
    # overflow, and inf * 0 would make the gradients NaN
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    decay = torch.exp(diff.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bqn,bsn->bqs", cm, bm)
    gate = decay * cb[..., None]
    xdt = x * dt[..., None]
    y_intra = torch.einsum("bqsh,bshp->bqhp", gate, xdt)
    y_state = torch.einsum("bqn,bhpn->bqhp", cm, state) * torch.exp(cum)[..., None]
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)                    # (B,Q,H)
    dstate = torch.einsum("bqhp,bqn,bqh->bhpn", xdt, bm, decay_to_end)
    new_state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + dstate
    return new_state, y_intra + y_state


def _out(w: Mamba2Weights, y: torch.Tensor, z: torch.Tensor, par) -> torch.Tensor:
    return rms_norm(y * F.silu(z), w.out_norm, par=par) @ w.out_proj


def _widths(w: Mamba2Weights, cfg: SSMConfig):
    """(di, N, H, P) of these weights: the rank's heads and inner width."""
    h = w.A_log.shape[-1]
    return h * cfg.head_dim, cfg.d_state, h, cfg.head_dim


def mamba2_forward(w: Mamba2Weights, cfg: SSMConfig, u: torch.Tensor, par=SINGLE
                   ) -> torch.Tensor:
    """The chunked SSD forward: u (B, S, d_model) -> (B, S, d_model) (the
    rank's partial sum under ``par``).  The chunk, ``min(cfg.chunk, S)``,
    must divide S."""
    b, s, _ = u.shape
    di, st, h, pd = _widths(w, cfg)
    z, xbc, dt_raw = torch.split(u @ w.in_proj, [di, di + 2 * st, h], dim=-1)
    xbc = _depthwise_conv(xbc, w.conv_w, w.conv_b)
    x, bm, cm = torch.split(xbc, [di, st, st], dim=-1)
    dt = _softplus(dt_raw.to(torch.float32) + w.dt_bias.to(torch.float32))   # (B,S,H)
    a = -torch.exp(w.A_log.to(torch.float32))
    x_h = x.reshape(b, s, h, pd).to(torch.float32)
    bm, cm = bm.to(torch.float32), cm.to(torch.float32)
    q = min(cfg.chunk, s)
    if s % q:
        raise AssertionError(f"chunk {q} must divide seq {s}")
    state = torch.zeros((b, h, pd, st), dtype=torch.float32, device=u.device)
    ys = []
    for lo in range(0, s, q):
        part = slice(lo, lo + q)
        state, y = _ssd_chunk(state, x_h[:, part], dt[:, part], bm[:, part], cm[:, part], a)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = y + x_h * w.D.to(torch.float32)[None, None, :, None]
    return _out(w, y.reshape(b, s, di).to(u.dtype), z, par)


def init_ssm_cache(batch: int, cfg: SSMConfig, dtype: torch.dtype, device=None,
                   n: int = 1, parts: int = 1) -> Cache:
    """Zeroed decode cache of ``n`` layers: the state (n, B, H, P, N) f32 and
    the convolution's last K-1 inputs (n, B, K-1, C) in ``dtype``; with
    ``parts`` (the model axis the heads split over) a rank's H / parts heads
    and di / parts + 2 N channels."""
    return {"state": torch.zeros((n, batch, cfg.n_heads // parts, cfg.head_dim, cfg.d_state),
                                 dtype=torch.float32, device=device),
            "conv": torch.zeros((n, batch, cfg.conv_kernel - 1,
                                 cfg.d_inner // parts + 2 * cfg.d_state), dtype=dtype,
                                device=device)}


def mamba2_decode(w: Mamba2Weights, cfg: SSMConfig, u: torch.Tensor, cache: Cache,
                  par=SINGLE) -> torch.Tensor:
    """One decode step: u (B, 1, d_model) -> (B, 1, d_model); the cache
    {"state", "conv"} of this layer is written in place."""
    b = u.shape[0]
    di, st, h, pd = _widths(w, cfg)
    z, xbc_new, dt_raw = torch.split(u[:, 0] @ w.in_proj, [di, di + 2 * st, h], dim=-1)
    window = torch.cat([cache["conv"], xbc_new[:, None, :]], dim=1)         # (B,K,C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, w.conv_w) + w.conv_b)
    x, bm, cm = torch.split(xbc, [di, st, st], dim=-1)
    dt = _softplus(dt_raw.to(torch.float32) + w.dt_bias.to(torch.float32))   # (B,H)
    a = -torch.exp(w.A_log.to(torch.float32))
    x_h = x.reshape(b, h, pd).to(torch.float32)
    dstate = torch.einsum("bhp,bn,bh->bhpn", x_h, bm.to(torch.float32), dt)
    state = cache["state"] * torch.exp(dt * a)[:, :, None, None] + dstate
    y = torch.einsum("bn,bhpn->bhp", cm.to(torch.float32), state)
    y = y + x_h * w.D.to(torch.float32)[None, :, None]
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:])
    return _out(w, y.reshape(b, di).to(u.dtype), z, par)[:, None, :]


def _mark_mamba(mixer: nn.Module, cfg: SSMConfig, par) -> None:
    """The heads over ``model``: the spec's ``out_proj`` (heads-in), but
    ``in_proj`` by sections [z, x by heads, B, C whole, dt by heads] (the
    spec cuts the concatenation straight across), ``conv_w``/``conv_b`` [x
    by heads, B, C whole] and ``A_log``, ``dt_bias``, ``D``, ``out_norm``
    by heads (the spec replicates them)."""
    m, r = par.model_size, par.model_rank
    di, st, h = cfg.d_inner, cfg.d_state, cfg.n_heads
    xbc = ((di, True), (st, False), (st, False))
    departures = {"in_proj.w": Layout(-1, m, r, ((di, True),) + xbc + ((h, True),)),
                  "conv_w": Layout(-1, m, r, xbc), "conv_b": Layout(-1, m, r, xbc)}
    departures.update({name: Layout(-1, m, r)
                       for name in ("A_log", "dt_bias", "D", "out_norm.scale")})
    mark_by_rule(mixer, par, departures=departures)


def _mamba_weights(mixer: nn.Module) -> Mamba2Weights:
    """The mixer's weights, the whole B and C sections of ``in_proj``,
    ``conv_w`` and ``conv_b`` taking their gradient summed over
    ``model``."""
    group = mixer.par.model_group
    return Mamba2Weights(shared_sections(mixer.in_proj.w, group),
                         shared_sections(mixer.conv_w, group),
                         shared_sections(mixer.conv_b, group), mixer.A_log, mixer.dt_bias,
                         mixer.D, mixer.out_norm.scale, mixer.out_proj.w)


class Mamba2(nn.Module):
    """The Mamba2 mixer: ``in_proj`` to [z, x, B, C, dt], the causal
    depthwise convolution over [x, B, C] (``conv_w``, ``conv_b``), the SSD
    with ``A_log``, ``dt_bias`` and the skip ``D``, ``out_norm`` on the
    z-gated output and ``out_proj``; with ``par`` this rank's heads (see
    the module docstring)."""

    def __init__(self, cfg: SSMConfig, *, dtype: torch.dtype = torch.float32, device=None,
                 par=None):
        super().__init__()
        self.cfg = cfg
        self.par = par = optional(par).over(cfg.n_heads)
        kw = dict(dtype=dtype, device=device)
        m = par.model_size
        h, di = cfg.n_heads // m, cfg.d_inner // m
        c = di + 2 * cfg.d_state
        self.in_proj = Linear(cfg.d_model, di + c + h, **kw)
        self.conv_w = nn.Parameter(torch.empty((cfg.conv_kernel, c), **kw))
        self.conv_b = nn.Parameter(torch.empty((c,), **kw))
        self.A_log = nn.Parameter(torch.empty((h,), **kw))
        self.dt_bias = nn.Parameter(torch.empty((h,), **kw))
        self.D = nn.Parameter(torch.empty((h,), **kw))
        self.out_norm = RMSNorm(di, par=par, **kw)
        self.out_proj = Linear(di, cfg.d_model, **kw)
        _mark_mamba(self, cfg, par)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``mamba2_init``: conv_w ~ N(0, 0.1^2), A_log =
        log(linspace(1, 16, H)), dt_bias 0, D 1."""
        self.in_proj.reset_parameters(generator)
        conv = torch.randn(self.conv_w.shape, generator=generator, device=generator.device)
        self.conv_w.copy_(conv * 0.1)
        self.conv_b.zero_()
        h = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h, device=self.A_log.device)))
        self.dt_bias.zero_()
        self.D.fill_(1.0)
        self.out_norm.reset_parameters()
        self.out_proj.reset_parameters(generator)

    def weights(self) -> Mamba2Weights:
        return _mamba_weights(self)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        par = self.par
        return leave(mamba2_forward(self.weights(), self.cfg, enter(u, par), par), par)

    def decode(self, u: torch.Tensor, cache: Cache) -> torch.Tensor:
        return leave(mamba2_decode(self.weights(), self.cfg, u, cache, self.par), self.par)


class StackedMamba2(nn.Module):
    """n slots' :class:`Mamba2` (the same parameters, each with a leading
    slot axis): u (n, B, S, d_model), one :func:`mamba2_forward` a slot over
    views of the stacked weights, so that a slot computes what its plain
    mixer computes; ``par`` as :class:`Mamba2`'s."""

    def __init__(self, cfg: SSMConfig, n: int, *, dtype: torch.dtype = torch.float32,
                 device=None, par=None):
        super().__init__()
        self.cfg = cfg
        self.par = par = optional(par).over(cfg.n_heads)
        kw = dict(dtype=dtype, device=device)
        m = par.model_size
        h, di = cfg.n_heads // m, cfg.d_inner // m
        c = di + 2 * cfg.d_state
        self.in_proj = StackedLinear(n, cfg.d_model, di + c + h, **kw)
        self.conv_w = nn.Parameter(torch.zeros((n, cfg.conv_kernel, c), **kw))
        self.conv_b = nn.Parameter(torch.zeros((n, c), **kw))
        self.A_log = nn.Parameter(torch.zeros((n, h), **kw))
        self.dt_bias = nn.Parameter(torch.zeros((n, h), **kw))
        self.D = nn.Parameter(torch.zeros((n, h), **kw))
        self.out_norm = StackedRMSNorm(n, di, par=par, **kw)
        self.out_proj = StackedLinear(n, di, cfg.d_model, **kw)
        _mark_mamba(self, cfg, par)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        par, w = self.par, _mamba_weights(self)
        u = enter(u, par)
        return leave(torch.stack([mamba2_forward(Mamba2Weights(*(t[r] for t in w)), self.cfg,
                                                 ur, par) for r, ur in enumerate(u)]), par)


def mamba2_forward_reference(mixer: Mamba2, u: torch.Tensor) -> torch.Tensor:
    """Token-by-token recurrent oracle of :meth:`Mamba2.forward` (tests
    only)."""
    cache = {k: v[0] for k, v in init_ssm_cache(u.shape[0], mixer.cfg, u.dtype,
                                                u.device).items()}
    return torch.cat([mixer.decode(u[:, t:t + 1], cache) for t in range(u.shape[1])], dim=1)


__all__ = ["Mamba2", "Mamba2Weights", "SSMConfig", "StackedMamba2", "init_ssm_cache",
           "mamba2_decode", "mamba2_forward", "mamba2_forward_reference"]
