"""The tensor-core routes of B4's and B5's backwards, on the CPU.

  * The route choosers (``attention_bwd_route``, ``xent_bwd_route``):
    Qwen3-8B's train shapes and head dims 64, 80 and 256 in bf16 take the
    tensor cores; f32, head dim 32, a vocab of 151,937 and a misaligned
    view take the f32-FMA route.
  * B4: a plain emulation of the tensor-core backward's numerics (bf16
    inputs, f32 logits, dlogits rounded to bf16 panel by panel, bf16
    products with f32 accumulation, bf16 dW summed over chunks), run
    through ``fused_xent.xent_backward_tc`` with its kernel launch replaced,
    against ``jax.grad`` of ``ref.xent_reference`` and autograd of
    ``fused_xent_plain``, within ``chip_smoke.GRAD_REL["bfloat16"]``.
  * B5: a plain emulation of the tensor-core backward's tile walk (64-key
    warpgroup tiles against 64-query tiles for dK/dV, 64-row warpgroups
    against 64-key tiles for dQ, P^T and dS^T rounded to bf16 before the
    register-operand products, the GQA sum in head order; head dim 80 at
    the padded depth of 128, zero columns cut; head dim 256 on 64-key
    blocks, each warpgroup over its 128 columns) against ``jax.grad`` of
    the reference's ``attend`` and autograd of ``flash_attention_plain``,
    within the same bound.
  * The walks the kernels take (``flash_attention.bwd_tc_walks``) visit
    every live (query, key) pair exactly once and no dead tile, at the
    tiles of head dims 128 and 256 (each warpgroup of a D 256 block once
    over its columns); the tiles (``bwd_tc_tiles``) equal the source's.
  * The backward launchers refuse CPU tensors on either route.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import attention as jattn
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_xent as tfx
from _torch_threads import one_thread  # noqa: F401

GRAD_REL = 3e-2                  # chip_smoke.GRAD_REL["bfloat16"]
LOG2E = math.log2(math.e)


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    """The CPU path never builds or launches a kernel."""
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)
    tbuild.reset_launches()
    yield
    assert not any(tbuild.LAUNCHES.values()), tbuild.LAUNCHES


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous view whose base lies 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(math.prod(shape) + 8, dtype=dtype)
    off = next(i for i in range(1, 8) if (flat.data_ptr() + i * flat.element_size()) % 16)
    view = flat[off:off + math.prod(shape)].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _rel_err(got, want, zero_scale=0.0):
    """max |got - want| over max |want| (chip_smoke._rel_err)."""
    scale = float(want.abs().max()) if want.numel() else 0.0
    scale = scale or zero_scale
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------

# (q shape, kv shape, dtype) -> route
ATTN_BWD_ROUTES = {
    "qwen3_8b_train_bf16": ((4, 512, 32, 128), (4, 512, 8, 128), torch.bfloat16,
                            tfa.TENSOR_CORES),
    "d64_mqa_bf16": ((2, 128, 8, 64), (2, 128, 1, 64), torch.bfloat16, tfa.TENSOR_CORES),
    "qwen3_8b_train_f32": ((4, 512, 32, 128), (4, 512, 8, 128), torch.float32, tfa.F32_FMA),
    "d256_bf16": ((1, 300, 16, 256), (1, 300, 8, 256), torch.bfloat16, tfa.TENSOR_CORES),
    "d80_bf16": ((2, 37, 4, 80), (2, 37, 2, 80), torch.bfloat16, tfa.TENSOR_CORES),
    "d32_bf16": ((1, 256, 2, 32), (1, 256, 2, 32), torch.bfloat16, tfa.F32_FMA),
}


@pytest.mark.parametrize("case", sorted(ATTN_BWD_ROUTES))
def test_attention_bwd_route(case):
    qs, kvs, dtype, want = ATTN_BWD_ROUTES[case]
    q, k, v = _meta(qs, dtype), _meta(kvs, dtype), _meta(kvs, dtype)
    assert tfa.attention_bwd_route(q, k, v, _meta(qs, dtype), _meta(qs, dtype)) == want


def test_attention_bwd_route_of_a_misaligned_view():
    q, kv = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16), torch.zeros(
        (2, 16, 2, 64), dtype=torch.bfloat16)
    assert tfa.attention_bwd_route(q, kv, kv, q, q) == tfa.TENSOR_CORES
    bad_q, bad_kv = _misaligned((2, 16, 4, 64)), _misaligned((2, 16, 2, 64))
    for args in ((bad_q, kv, kv, q, q), (q, kv, bad_kv, q, q), (q, kv, kv, bad_q, q),
                 (q, kv, kv, q, bad_q)):
        assert tfa.attention_bwd_route(*args) == tfa.F32_FMA


# (h shape, W shape, dtype) -> route
XENT_BWD_ROUTES = {
    "qwen3_8b_train_bf16": ((2048, 4096), (4096, 151936), torch.bfloat16, tfx.TENSOR_CORES),
    "t333_bf16": ((333, 1024), (1024, 151936), torch.bfloat16, tfx.TENSOR_CORES),
    "qwen3_8b_train_f32": ((2048, 4096), (4096, 151936), torch.float32, tfx.F32_FMA),
    "v151937_bf16": ((129, 256), (256, 151937), torch.bfloat16, tfx.F32_FMA),
    "d36_bf16": ((8, 36), (36, 64), torch.bfloat16, tfx.F32_FMA),
}


@pytest.mark.parametrize("case", sorted(XENT_BWD_ROUTES))
def test_xent_bwd_route(case):
    hs, ws, dtype, want = XENT_BWD_ROUTES[case]
    assert tfx.xent_bwd_route(_meta(hs, dtype), _meta(ws, dtype)) == want


def test_xent_bwd_route_of_a_misaligned_view():
    w = torch.zeros((64, 256), dtype=torch.bfloat16)
    assert tfx.xent_bwd_route(torch.zeros((8, 64), dtype=torch.bfloat16), w) == tfx.TENSOR_CORES
    assert tfx.xent_bwd_route(_misaligned((8, 64)), w) == tfx.F32_FMA
    assert tfx.xent_bwd_route(torch.zeros((8, 64), dtype=torch.bfloat16),
                              _misaligned((64, 256))) == tfx.F32_FMA


def test_tensor_core_chunk_holds_half_a_gigabyte_of_bf16_dlogits():
    assert tfx.chunk_rows(151936, 2) == 1766
    assert tfx.chunk_rows(151936, 2) * 151936 * 2 <= tfx.CHUNK_BYTES
    assert -(-2048 // tfx.chunk_rows(151936, 2)) == 2        # a train step: two chunks


# ---------------------------------------------------------------------------
# B4: the tensor-core backward's numerics
# ---------------------------------------------------------------------------

def _dlogits_emulation(hc, weights, labels, lse, g, dl):
    """What ``xent_dlogits_tc`` writes for one chunk, panel by panel of 256
    columns (the last one partial), from f32 logits of the bf16 inputs;
    returns 0 (no error), as the launcher returns its cudaError_t."""
    v = weights.shape[1]
    for p0 in range(0, v, tfx.PANEL_V_TC):
        p1 = min(v, p0 + tfx.PANEL_V_TC)
        p = torch.exp(hc.float() @ weights[:, p0:p1].float() - lse[:, None])
        hit = (labels >= p0) & (labels < p1)
        rows = torch.nonzero(hit)[:, 0]
        p[rows, (labels[rows] - p0).long()] -= 1.0
        dl[:, p0:p1] = (p * g[:, None]).to(torch.bfloat16)
    return 0


def _xent_grad_err(dh, dw, ref_dh, ref_dw, labels):
    """chip_smoke._xent_grad_err: dh's rows with and without an in-range
    label, dW's columns hit and not hit by one, each on its own scale."""
    v = ref_dw.shape[1]
    inside = (labels >= 0) & (labels < v)
    hit = torch.zeros(v, dtype=torch.bool)
    hit[labels[inside].long()] = True
    parts = ((dh[inside], ref_dh[inside]), (dh[~inside], ref_dh[~inside]),
             (dw[:, hit], ref_dw[:, hit]), (dw[:, ~hit], ref_dw[:, ~hit]))
    return max(_rel_err(a, r) for a, r in parts if r.numel())


# (T, D, V, chunk rows): V 1,000 and 2,056 end in a partial 256-wide panel
XENT_CASES = {"t50_v1000_chunks3": (50, 64, 1000, 17), "t40_v2056_one_chunk": (40, 128, 2056, 64),
              "t33_v512_chunks2": (33, 96, 512, 20)}


@pytest.mark.parametrize("case", sorted(XENT_CASES))
def test_b4_tensor_core_numerics_match_jax_grad(case, monkeypatch):
    t, d, v, rows = XENT_CASES[case]
    monkeypatch.setattr(tfx, "CHUNK_BYTES", rows * 2 * v)
    monkeypatch.setattr(tfx, "_xent_dlogits_tc", _dlogits_emulation)
    assert tfx.chunk_rows(v, 2) == rows
    rng = np.random.default_rng(t)
    h = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(d, v)) * 0.02).astype(np.float32)).to(torch.bfloat16)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    labels[:5] = [-1, v, -100, 255, v - 1]                 # out of range, panel edges
    g = rng.normal(size=t).astype(np.float32)
    lab, tg = torch.from_numpy(labels), torch.from_numpy(g)
    assert tfx.xent_bwd_route(h, w) == tfx.TENSOR_CORES
    with torch.no_grad():
        lse = torch.logsumexp(h.float() @ w.float(), dim=-1)
        dh, dw, err = tfx.xent_backward_tc(h, w, lab, lse, tg)
    assert err == 0 and dh.dtype == dw.dtype == torch.bfloat16

    # the reference: jax.grad of xent_reference on the rows with an in-range
    # label; a row without one has the bare logsumexp as its loss (the
    # port's rule)
    inside = jnp.asarray((labels >= 0) & (labels < v))
    clipped = jnp.asarray(np.clip(labels, 0, v - 1))

    def jloss(h_, w_):
        per_tok = jnp.where(inside, ref.xent_reference(h_, w_, clipped),
                            jax.nn.logsumexp(h_ @ w_, axis=-1))
        return jnp.sum(per_tok * jnp.asarray(g))

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h.float().numpy()),
                                               jnp.asarray(w.float().numpy()))
    want = (torch.tensor(np.asarray(jdh)), torch.tensor(np.asarray(jdw)))
    err_jax = _xent_grad_err(dh, dw, *want, lab)
    th, tw = h.clone().requires_grad_(), w.clone().requires_grad_()
    plain = torch.autograd.grad(torch.sum(tfx.fused_xent_plain(th, tw, lab) * tg), (th, tw))
    err_plain = _xent_grad_err(dh, dw, *plain, lab)
    assert 0.0 < err_jax <= GRAD_REL and err_plain <= GRAD_REL, (err_jax, err_plain)


# ---------------------------------------------------------------------------
# B5: the tensor-core backward's tile walk
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _live(qi, kj, sq, sk, window, causal=True):
    """(len(qi), len(kj)) mask of live pairs."""
    diff = qi[:, None] - kj[None, :]
    m = (qi[:, None] < sq) & (kj[None, :] < sk)
    if causal:
        m = m & (diff >= 0)
    return m & (diff < window) if window > 0 else m


def _bwd_tc_emulation(q, k, v, out, dout, lse, window, causal=True):
    """dq, dk, dv (bf16) as the tensor-core kernels compute them: the walks
    of ``bwd_tc_walks`` at the tiles of ``bwd_tc_tiles(D)``, Q, K, V and dO
    at the padded depth (zero columns past D: TMA's fill), f32 products of
    bf16 operands, P^T and dS^T (dK/dV) and dS (dQ) rounded to bf16 before
    the register-operand products, each warpgroup's product over its own
    columns, the GQA sum over a group's heads in head order, the scale
    applied once; the padded columns come out 0 and are cut."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    t = tfa.bwd_tc_tiles(d)
    dp = t.depth
    scale = 1.0 / math.sqrt(d)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2)   # (B, H, Sq)
    qf, kf, vf, gf = (torch.nn.functional.pad(x.float(), (0, dp - d)) for x in (q, k, v, dout))
    lse2 = lse * LOG2E
    dkdv_walk, dq_walk = tfa.bwd_tc_walks(sq, sk, window, causal, d=d)
    # heads as (B, Hkv, group, S, DP); queries of head kvh * group + hh
    qh = qf.view(b, sq, hkv, group, dp).permute(0, 2, 3, 1, 4)
    gh = gf.view(b, sq, hkv, group, dp).permute(0, 2, 3, 1, 4)
    lh, dh_ = lse2.view(b, hkv, group, sq), delta.view(b, hkv, group, sq)
    kh, vh = kf.permute(0, 2, 1, 3), vf.permute(0, 2, 1, 3)        # (B, Hkv, Sk, DP)
    dk = torch.zeros((b, hkv, sk, dp))
    dv = torch.zeros((b, hkv, sk, dp))
    for (k0, wg), tiles in dkdv_walk.items():
        if not tiles:                           # keys past Sk, or seen by no query
            continue
        kw0, cols = tiles[0][1], t.cols(wg)
        keys = torch.arange(kw0, min(sk, kw0 + 64))
        for hh in range(group):
            for qt, _ in tiles:
                qi = torch.arange(qt, min(sq, qt + 64))
                live = _live(qi, keys, sq, sk, window, causal).T       # (keys, queries)
                st = kh[:, :, keys] @ qh[:, :, hh, qi].transpose(-1, -2)
                sc = torch.where(live, st * scale * LOG2E - lh[:, :, hh, qi][:, :, None, :],
                                 torch.tensor(-math.inf))
                pt = torch.exp2(sc)
                dpt = vh[:, :, keys] @ gh[:, :, hh, qi].transpose(-1, -2)
                dst = pt * (dpt - dh_[:, :, hh, qi][:, :, None, :])
                dv[:, :, keys, cols] += _bf16(pt) @ gh[:, :, hh, qi][..., cols]
                dk[:, :, keys, cols] += _bf16(dst) @ qh[:, :, hh, qi][..., cols]
    # dQ: every query head against its KV head
    qa, ga = qf.permute(0, 2, 1, 3), gf.permute(0, 2, 1, 3)        # (B, H, Sq, DP)
    ka = kh.repeat_interleave(group, dim=1)
    va = vh.repeat_interleave(group, dim=1)
    dq = torch.zeros((b, h, sq, dp))
    for (_, wg), tiles in dq_walk.items():
        cols = t.cols(wg)
        for qw0, kt in tiles:
            qi = torch.arange(qw0, min(sq, qw0 + 64))
            keys = torch.arange(kt, min(sk, kt + 64))
            live = _live(qi, keys, sq, sk, window, causal)
            s = qa[:, :, qi] @ ka[:, :, keys].transpose(-1, -2)
            sc = torch.where(live, s * scale * LOG2E - lse2[:, :, qi][..., None],
                             torch.tensor(-math.inf))
            dp = ga[:, :, qi] @ va[:, :, keys].transpose(-1, -2)
            ds = torch.exp2(sc) * (dp - delta[:, :, qi][..., None])
            dq[:, :, qi, cols] += _bf16(ds) @ ka[:, :, keys][..., cols]
    for x in (dq, dk, dv):
        assert not x[..., d:].any()             # zero columns in, zero columns out
    return ((dq[..., :d] * scale).permute(0, 2, 1, 3).to(torch.bfloat16),
            (dk[..., :d] * scale).permute(0, 2, 1, 3).to(torch.bfloat16),
            dv[..., :d].permute(0, 2, 1, 3).to(torch.bfloat16))


# (B, Sq, Sk, H, Hkv, D, window): GQA group 4 and 1, a window, ragged S, Sq < Sk;
# head dim 80 (the padded depth) with a window and a ragged S, head dim 256
# (64-key blocks, D split between the warpgroups) with GQA group 2 and a window
ATTN_CASES = {"group4": (2, 150, 150, 8, 2, 64, 0),
              "group1_window48": (1, 200, 200, 2, 2, 128, 48),
              "mqa_window40_ragged": (2, 97, 97, 4, 1, 64, 40),
              "group4_sq70_sk133": (1, 70, 133, 4, 1, 128, 0),
              "d80_window40_ragged": (2, 131, 131, 4, 2, 80, 40),
              "d256_group2_window48": (1, 150, 150, 4, 2, 256, 48)}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_b5_tensor_core_tile_walk_matches_jax_grad(case):
    b, sq, sk, h, hkv, d, window = ATTN_CASES[case]
    rng = np.random.default_rng(sq + sk)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
                     for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)))
    assert tfa.attention_bwd_route(q, k, v, q, dout) == tfa.TENSOR_CORES
    out = tfa.flash_attention_plain(q, k, v, window=window)
    mask = tfa.causal_mask(torch.arange(sq), torch.arange(sk), window)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float().repeat_interleave(h // hkv, dim=2)) / math.sqrt(d)
    lse = torch.logsumexp(torch.where(mask, scores, torch.tensor(-math.inf)), dim=-1)
    got = _bwd_tc_emulation(q, k, v, out, dout, lse, window)

    jmask = jattn.causal_mask(jnp.arange(sq), jnp.arange(sk), window)

    def jloss(q_, k_, v_):
        o = jattn.attend(q_, jattn._repeat_kv(k_, h // hkv), jattn._repeat_kv(v_, h // hkv),
                         jmask, 1.0 / math.sqrt(d))
        return jnp.sum(o * jnp.asarray(dout.float().numpy()))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.float().numpy())
                                                  for x in (q, k, v)))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    plain = torch.autograd.grad(tfa.flash_attention_plain(tq, tk, tv, window=window),
                                (tq, tk, tv), grad_outputs=dout)
    for want in ([torch.tensor(np.asarray(x)) for x in jgrads], plain):
        scale = max(float(r.abs().max()) for r in want)
        errs = [_rel_err(a, r, scale) for a, r in zip(got, want)]
        assert all(a.shape == r.shape for a, r in zip(got, want))
        assert 0.0 < max(errs) <= GRAD_REL, errs


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------

def _walk_counts(walk, live, d):
    """Each column group's count of visits to every (query, key) pair: one
    count for a walk whose warpgroups split the rows, one a warpgroup for a
    walk whose warpgroups split D.  Fails on a tile with no live pair."""
    split = tfa.bwd_tc_tiles(d).split
    counts = [np.zeros(live.shape, dtype=np.int64) for _ in range(2 if split else 1)]
    for (_, wg), tiles in walk.items():
        for q0, k0 in tiles:
            tile = np.zeros(live.shape, dtype=bool)
            tile[q0:q0 + 64, k0:k0 + 64] = True
            hit = tile & live
            assert hit.any(), f"a dead tile walked: queries {q0}, keys {k0}"
            counts[wg if split else 0] += hit
    return counts


def _by_head_dim(shapes):
    """``shapes`` at head dim 128 (ids unchanged) and at 256, whose walk has
    64-key (64-row) blocks and both warpgroups on the same tiles."""
    return ([pytest.param(*s, 128, id="-".join(map(str, s))) for s in shapes]
            + [pytest.param(*s, 256, id="d256-" + "-".join(map(str, s))) for s in shapes])


@pytest.mark.parametrize("sq,sk,window,d", _by_head_dim(
    [(512, 512, 0), (480, 480, 64), (37, 37, 0), (1, 1, 0), (70, 133, 0), (300, 300, 128),
     (200, 257, 5), (129, 129, 1)]))
def test_walks_visit_every_live_pair_once(sq, sk, window, d):
    qi, kj = np.arange(sq), np.arange(sk)
    diff = qi[:, None] - kj[None, :]
    live = (diff >= 0) & ((diff < window) if window > 0 else True)
    t = tfa.bwd_tc_tiles(d)
    for walk, rows_are_keys in zip(tfa.bwd_tc_walks(sq, sk, window, d=d), (True, False)):
        for count in _walk_counts(walk, live, d):
            np.testing.assert_array_equal(count, live.astype(np.int64))
        # the blocks of the grid: one per t.keys keys (dK/dV) or t.rows
        # query rows (dQ): 128, or 64 at D 256
        blocks = {blk for blk, _ in walk}
        step = t.keys if rows_are_keys else t.rows
        assert step == (64 if d == 256 else 128)
        assert blocks == set(range(0, sk if rows_are_keys else sq, step))


@pytest.mark.parametrize("sq,sk,window,d", _by_head_dim(
    [(256, 256, 0), (256, 384, 0), (300, 130, 0), (200, 257, 5), (129, 64, 70), (64, 200, 16)]))
def test_non_causal_walks_visit_every_live_pair_once(sq, sk, window, d):
    """The walks with ``causal=False`` (the dK/dV kernel's queries from 0,
    the dQ kernel's keys to Sk): every live pair (only the window masks;
    no row without a key) once, no dead tile."""
    assert not tfa.has_dead_rows(sq, sk, window, False)
    qi, kj = np.arange(sq), np.arange(sk)
    diff = qi[:, None] - kj[None, :]
    live = (diff < window) if window > 0 else np.ones((sq, sk), dtype=bool)
    for walk in tfa.bwd_tc_walks(sq, sk, window, causal=False, d=d):
        for count in _walk_counts(walk, live, d):
            np.testing.assert_array_equal(count, live.astype(np.int64))


def test_bwd_tiles_equal_the_source():
    """``bwd_tc_tiles`` against ``BwdTile<D>``'s lines in the source (the
    launcher also checks them against the library on the card's first
    launch), ``TC_DEPTH`` against ``sm90::box_depth``, and both kernels'
    dispatch takes every head dim of the route."""
    text = (tbuild.CSRC / "flash_attention_bwd_tc.cu").read_text()
    box = int(re.search(r"box_depth\(int d\) \{ return \(d \+ 63\) / (\d+) \* \1; \}",
                        (tbuild.CSRC / "sm90.cuh").read_text()).group(1))
    assert "DP = sm90::box_depth(D);" in text
    split_at = int(re.search(r"kSplit = DP == (\d+);", text).group(1))
    bkv = [int(x) for x in re.search(r"BKV = kSplit \? (\d+) : (\d+);", text).groups()]
    bqr = [int(x) for x in re.search(r"BQR = kSplit \? (\d+) : (\d+);", text).groups()]
    bq = int(re.search(r"constexpr int BQ = (\d+);", text).group(1))
    bk = int(re.search(r"constexpr int BK = (\d+);", text).group(1))
    fwd = (tbuild.CSRC / "flash_attention_tc.cu").read_text()
    assert "DP = sm90::box_depth(D);" in fwd
    for d in tfa.TC_BWD_HEAD_DIMS:
        dp = -(-d // box) * box
        split = dp == split_at
        assert tfa.bwd_tc_tiles(d) == (dp, bkv[0 if split else 1], bq, bqr[0 if split else 1],
                                       bk, split), d
        assert tfa.TC_DEPTH[d] == dp
        assert re.search(rf"case {d}: return launch<{d}>", text), d
        assert re.search(rf"case {d}: return launch<{d}>", fwd), d
    consts = tfa.bwd_tc_constants()
    assert list(consts)[-2:] == ["BQ", "BK"] and len(consts) == 4 * 4 + 2


# (B, Sq, Sk, H, Hkv, D, window), not causal: Sq = Sk, Sq < Sk, Sq > Sk, a
# window with every row live
NON_CAUSAL_CASES = {"self_group2": (1, 130, 130, 4, 2, 64, 0),
                    "sq70_sk133": (1, 70, 133, 4, 1, 128, 0),
                    "sq150_sk64_group1": (1, 150, 64, 2, 2, 64, 0),
                    "window40_sq100_sk70": (1, 100, 70, 4, 2, 64, 40)}


@pytest.mark.parametrize("case", sorted(NON_CAUSAL_CASES))
def test_b5_tensor_core_tile_walk_non_causal_matches_jax_grad(case):
    """The tensor-core backward's numerics over its non-causal walks against
    ``jax.grad`` of the reference's ``attend`` under an all-true mask (a
    window's mask with one) and autograd of the plain version."""
    b, sq, sk, h, hkv, d, window = NON_CAUSAL_CASES[case]
    rng = np.random.default_rng(sq * 3 + sk)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(torch.bfloat16)
                     for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d), (b, sq, h, d)))
    out = tfa.flash_attention_plain(q, k, v, causal=False, window=window)
    mask = tfa.causal_mask(torch.arange(sq), torch.arange(sk), window, causal=False)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float().repeat_interleave(h // hkv, dim=2)) / math.sqrt(d)
    lse = torch.logsumexp(torch.where(mask, scores, torch.tensor(-math.inf)), dim=-1)
    got = _bwd_tc_emulation(q, k, v, out, dout, lse, window, causal=False)

    jmask = jnp.asarray(mask.numpy())

    def jloss(q_, k_, v_):
        o = jattn.attend(q_, jattn._repeat_kv(k_, h // hkv), jattn._repeat_kv(v_, h // hkv),
                         jmask, 1.0 / math.sqrt(d))
        return jnp.sum(o * jnp.asarray(dout.float().numpy()))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x.float().numpy())
                                                  for x in (q, k, v)))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    plain = torch.autograd.grad(tfa.flash_attention_plain(tq, tk, tv, causal=False,
                                                          window=window),
                                (tq, tk, tv), grad_outputs=dout)
    for want in ([torch.tensor(np.asarray(x)) for x in jgrads], plain):
        scale = max(float(r.abs().max()) for r in want)
        errs = [_rel_err(a, r, scale) for a, r in zip(got, want)]
        assert all(a.shape == r.shape for a, r in zip(got, want))
        assert 0.0 < max(errs) <= GRAD_REL, errs


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_backward_launchers_refuse_cpu_tensors_on_either_route():
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 8))
    assert tfa.attention_bwd_route(q, kv, kv, q, q) == tfa.TENSOR_CORES
    for route in (None, tfa.TENSOR_CORES, tfa.F32_FMA):
        with pytest.raises(ValueError, match="CUDA"):
            tfa.flash_attention_bwd(q, kv, kv, q, q, lse, route=route)
    h, w = torch.zeros((4, 8), dtype=torch.bfloat16), torch.zeros((8, 16), dtype=torch.bfloat16)
    labels = torch.zeros((4,), dtype=torch.int32)
    assert tfx.xent_bwd_route(h, w) == tfx.TENSOR_CORES
    for route in (None, tfx.TENSOR_CORES, tfx.F32_FMA):
        with pytest.raises(ValueError, match="CUDA"):
            tfx.fused_xent_bwd(h, w, labels, torch.zeros(4), torch.zeros(4), route=route)
