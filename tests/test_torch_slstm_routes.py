"""B7's routes and the persistent kernels' partitions, on the CPU.

  * ``slstm_route``: the xLSTM-1.3B prefill shapes (T 512 and 2,048, B 4, d
    2,048, H 4, bf16 and the f32 check's f32), the smoke config's and
    ``chip_smoke.py``'s phase-1 shapes take the route ``chip_smoke``'s
    ``SLSTM_ROUTES`` names on an H100 (a stand-in for the card's 132 SMs and
    227 KB of shared memory a block); a misaligned r takes the step kernel.
  * ``persistent_plan``: one block an SM at most, every unit in one block,
    the shared memory within the block's; refusals (B 9, dh % 4 != 0, R's
    slice too large).
  * The Python copies of the persistent kernel's constants equal the
    ``constexpr`` lines of ``csrc/slstm_scan_persistent.cu``
    (``build.check_constants`` holds them against the library on the card).
  * A CPU model of the persistent kernel (blocks of ``units`` units, a column
    group of one gate and 4 units a warp, lane l summing k = l, l + 32, ...
    in order, the lanes' sums met in the kernel's reduce-scatter butterfly,
    h double-buffered as [2][rows][d], c/n/m kept per (row, unit)) against
    ``slstm_scan_plain``, ``repro.kernels.ref.slstm_scan_reference`` and the
    Pallas kernel in interpret mode, T <= 40, d <= 96, H 1, 2 and 4, in f32,
    within 1e-5; every gate column is computed by exactly one warp.
  * The backward's ``slstm_bwd_route`` and ``persistent_bwd_plan``: the
    route ``chip_smoke``'s ``SLSTM_BWD_ROUTES`` names at every phase-1
    shape, xLSTM-1.3B's train shape (bf16, the f32 unit's f32, a stacked
    slot's r), a misaligned r; one block an SM, the heads a block spans
    counted in its dz slice (blocks straddling two heads; a shape whose
    forward fits and whose backward's dz slice does not); its constants.
  * A CPU model of the persistent backward (blocks of ``units`` units, a
    group of 4 units and one range of e a warp, lane l summing 4 e's at
    c = lo + l + 32 j, the reduce-scatter butterfly, the ranges added in
    order, the carry per (row, unit)) against ``slstm_scan_bwd_plain`` and
    ``jax.grad`` of the reference, within 1e-5; every unit's recurrent
    share computed by exactly one warp group.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import slstm_scan as tss
from _torch_threads import one_thread  # noqa: F401

MODEL_ATOL = 1e-5
H100 = (132, 232448)             # an H100 SXM's SMs and shared memory a block


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _h100(monkeypatch):
    """The card's limits as an H100 reports them; no kernel builds or runs."""
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "device_limits", lambda index: H100)
    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)
    tbuild.reset_launches()
    yield
    assert not any(tbuild.LAUNCHES.values()), tbuild.LAUNCHES


def _meta(shape, dtype):
    t, b, d, h = shape
    pre = torch.empty((t, b, 4 * d), dtype=dtype, device="meta")
    r = torch.empty((h, d // h, 4 * d // h), dtype=dtype, device="meta")
    return pre, r


# the xLSTM-1.3B prefills (phase 9: 4 x 512 in bf16 and in f32, 4 x 2,048),
# the smoke config (phase 4, f32), and the long timed shape
PATH_ROUTES = {"prefill_bf16": ((512, 4, 2048, 4), torch.bfloat16, tss.PERSISTENT),
               "prefill_f32": ((512, 4, 2048, 4), torch.float32, tss.PERSISTENT),
               "long_prefill_bf16": ((2048, 4, 2048, 4), torch.bfloat16, tss.PERSISTENT),
               "smoke_f32": ((16, 4, 256, 4), torch.float32, tss.PERSISTENT),
               "timed_long_bf16": (CS.SLSTM_LONG, torch.bfloat16, tss.PERSISTENT)}


@pytest.mark.parametrize("case", sorted(PATH_ROUTES))
def test_slstm_route_of_the_main_paths(case):
    shape, dtype, want = PATH_ROUTES[case]
    assert tss.slstm_route(*_meta(shape, dtype)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CS.SLSTM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_slstm_route_of_phase_1_shapes(shape, dtype):
    want = CS.SLSTM_ROUTES[shape][dtype == torch.bfloat16]
    assert tss.slstm_route(*_meta(shape, dtype)) == want


def test_slstm_route_of_a_misaligned_r():
    pre = torch.zeros((4, 2, 4 * 80))
    flat = torch.zeros(2 * 40 * 160 + 4)
    off = next(i for i in range(1, 4) if (flat.data_ptr() + 4 * i) % 16)
    r = flat[off:off + 2 * 40 * 160].view(2, 40, 160)
    assert r.is_contiguous() and r.data_ptr() % 16
    assert tss.slstm_route(pre, r) == tss.STEP
    assert tss.slstm_route(pre, r.clone()) == tss.PERSISTENT


@pytest.mark.parametrize("b,d,h,elt", [(4, 2048, 4, 2), (4, 2048, 4, 4), (4, 2048, 2, 2),
                                       (5, 96, 2, 4), (1, 612, 3, 4), (8, 4096, 8, 2),
                                       (3, 80, 2, 2)])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_persistent_plan_fits_one_block_an_sm(b, d, h, elt, sms):
    plan = tss.persistent_plan(b, d, h, elt, sms, H100[1])
    if plan is None:
        return
    units, blocks, smem, r_elt = plan
    rows = tss.persistent_rows(b)
    assert units % tss.GROUP_UNITS == 0 and units * rows <= tss.PERSISTENT_THREADS
    assert blocks <= sms and (blocks - 1) * units < d <= blocks * units
    assert smem == tss.persistent_smem(d, d // h, units, rows, elt, r_elt) <= H100[1]
    # R in f32 wherever that fits
    assert r_elt == 4 or tss.persistent_smem(d, d // h, units, rows, elt, 4) > H100[1]
    # the fewest units a block that keeps to one block an SM
    assert units == tss.GROUP_UNITS or -(-d // (units - tss.GROUP_UNITS)) > sms


def test_persistent_plan_refusals():
    assert tss.persistent_plan(9, 256, 4, 4, 132) is None             # past 8 rows
    assert tss.persistent_plan(2, 90, 3, 4, 132) is None              # dh 30
    assert tss.persistent_plan(4, 2048, 1, 2, 132) is None            # R's slice 272 KB
    assert tss.persistent_plan(4, 2048, 4, 2, 132)[3] == 4            # R widened once
    assert tss.persistent_plan(4, 2048, 2, 4, 132) is None
    assert tss.persistent_plan(4, 2048, 2, 2, 132) is not None
    assert tss.persistent_plan(4, 2048, 4, 2, 132, smem=64 * 1024) is None


def test_persistent_constants_equal_the_source():
    text = (tbuild.CSRC / "slstm_scan_persistent.cu").read_text()
    for const, value in tss._PERSISTENT_CONSTANTS.items():
        assert re.findall(rf"constexpr int {const} = (\d+);", text) == [str(value)], const


# ---------------------------------------------------------------------------
# a CPU model of the persistent kernel
# ---------------------------------------------------------------------------

def _butterfly(partial):
    """The kernel's reduce-scatter over 32 lanes: partial (32, N) f32 (N =
    16 or 32 sums a lane) -> the N sums, each added in the kernel's order."""
    v = partial.copy()
    lanes = np.arange(32)
    n = v.shape[1]
    for off in (16, 8, 4, 2, 1):
        partner = lanes ^ off
        if n > 1:
            upper = (lanes & off) != 0
            half = n // 2
            send = np.where(upper[:, None], v[:, :half], v[:, half:n])
            keep = np.where(upper[:, None], v[:, half:n], v[:, :half])
            v[:, :half] = keep + send[partner]
            n = half
        else:
            v[:, 0] = v[:, 0] + v[partner, 0]
    per = 32 // partial.shape[1]
    return v[::per, 0]


def _gate(z, c, n, m):
    """One step's gating in f32 numpy, as slstm_gates.cuh computes it."""
    li, lf_raw, zz, oo = z
    lf = np.minimum(lf_raw, 0).astype(np.float32) - np.log1p(np.exp(-np.abs(lf_raw)))
    m_new = np.maximum(lf + m, li)
    ig = np.exp(li - m_new)
    fg = np.exp(lf + m - m_new)
    c = fg * c + ig * np.tanh(zz)
    n = fg * n + ig
    h = (1 / (1 + np.exp(-oo))) * c / np.maximum(n, 1)
    return h.astype(np.float32), c.astype(np.float32), n.astype(np.float32), m_new


def persistent_model(pre, r, n_heads, sms):
    """What slstm_scan_persistent_kernel computes, block by block and warp by
    warp, in f32 numpy: pre (T, B, 4d), r (H, dh, 4dh) -> (T, B, d)."""
    t_len, b, d4 = pre.shape
    d = d4 // 4
    dh = d // n_heads
    units, blocks, _, _ = tss.persistent_plan(b, d, n_heads, 4, sms)
    rows = tss.persistent_rows(b)
    per_gate = units // tss.GROUP_UNITS
    hbuf = np.zeros((2, rows, d), np.float32)
    c = np.zeros((rows, d), np.float32)
    n = np.zeros((rows, d), np.float32)
    m = np.full((rows, d), tss.M_INIT, np.float32)
    out = np.zeros((t_len, b, d), np.float32)
    k_pad = -(-dh // 32) * 32
    for t in range(t_len):
        rec = np.zeros((4, rows, d), np.float32)
        seen = np.zeros(4 * d, int)
        if t > 0:
            h_s = hbuf[(t - 1) % 2]
            for blk in range(blocks):
                u0 = blk * units
                for q in range(units):                       # a warp's column group
                    g, uq = q // per_gate, (q % per_gate) * tss.GROUP_UNITS
                    if u0 + uq >= d:
                        continue
                    cols = g * d + u0 + uq + np.arange(tss.GROUP_UNITS)
                    heads = cols // (4 * dh)
                    assert (heads == heads[0]).all()         # one head a group
                    seen[cols] += 1
                    w = np.zeros((k_pad, 4), np.float32)
                    w[:dh] = r[heads[0]][:, cols - heads[0] * 4 * dh]
                    hv = np.zeros((rows, k_pad), np.float32)
                    hv[:, :dh] = h_s[:, heads[0] * dh:(heads[0] + 1) * dh]
                    partial = np.zeros((32, rows, 4), np.float32)
                    for j in range(k_pad // 32):             # lane l: k = l + 32 j
                        ks = slice(32 * j, 32 * j + 32)
                        partial += hv[:, ks].T[:, :, None] * w[ks][:, None, :]
                    sums = _butterfly(partial.reshape(32, rows * 4))
                    rec[g, :, u0 + uq:u0 + uq + 4] = sums.reshape(rows, 4)
            assert (seen == 1).all()
        z = np.zeros((4, rows, d), np.float32)
        z[:, :b] = pre[t].reshape(b, 4, d).transpose(1, 0, 2)
        z = z + rec
        h, c, n, m = _gate(z, c, n, m)
        h[b:] = 0.0
        hbuf[t % 2] = h
        out[t] = h[:b]
    return out


# (T, B, d, H, the stand-in's SMs): H 1/2/4, ragged last blocks and dead
# column groups, 8 rows (B 5), a block a column group
MODEL_CASES = {"h4_b3_blocks6": (40, 3, 96, 4, 7), "h2_b5_ragged": (33, 5, 80, 2, 9),
               "h1_b2": (24, 2, 64, 1, 132), "h2_b4": (17, 4, 96, 2, 132),
               "h4_b1_ragged": (9, 1, 48, 4, 5)}


def _model_inputs(t, b, d, h, seed):
    rng = np.random.default_rng(seed)
    dh = d // h
    pre = rng.normal(size=(t, b, 4 * d)).astype(np.float32)
    r = (rng.normal(size=(h, dh, 4 * dh)) / np.sqrt(dh)).astype(np.float32)
    return pre, r


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_persistent_model_matches_plain_and_reference(case):
    t, b, d, h, sms = MODEL_CASES[case]
    units, blocks, _, _ = tss.persistent_plan(b, d, h, 4, sms)
    assert blocks > 1 or d <= units
    pre, r = _model_inputs(t, b, d, h, seed=len(case))
    got = persistent_model(pre, r, h, sms)
    plain = tss.slstm_scan_plain(torch.from_numpy(pre), torch.from_numpy(r), h).numpy()
    want = np.asarray(ref.slstm_scan_reference(jnp.asarray(pre), jnp.asarray(r), n_heads=h))
    np.testing.assert_allclose(got, plain, atol=MODEL_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=MODEL_ATOL, rtol=0)


def test_persistent_model_matches_the_pallas_kernel():
    pre, r = _model_inputs(16, 2, 32, 2, seed=3)
    want = jops.slstm_scan(jnp.asarray(pre), jnp.asarray(r), n_heads=2, interpret=True)
    np.testing.assert_allclose(persistent_model(pre, r, 2, 3), np.asarray(want),
                               atol=MODEL_ATOL, rtol=0)


def test_butterfly_sums_every_lane_once():
    """Lane l's value i is 2^l in slot i: each sum comes out as 2^32 - 1
    times its slot's scale, so every lane was added exactly once."""
    for n in (16, 32):
        partial = (np.float64(2.0) ** np.arange(32))[:, None] * (1 + np.arange(n))[None, :]
        got = _butterfly(partial)
        np.testing.assert_array_equal(got, (2.0 ** 32 - 1) * (1 + np.arange(n)))


# ---------------------------------------------------------------------------
# the backward's route and the persistent backward's plan
# ---------------------------------------------------------------------------

def _meta_bwd(shape, dtype):
    t, b, d, h = shape
    dout = torch.empty((t, b, d), dtype=dtype, device="meta")
    return dout, _meta(shape, dtype)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CS.SLSTM_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_slstm_bwd_route_of_phase_1_shapes(shape, dtype):
    want = CS.SLSTM_BWD_ROUTES[shape][dtype == torch.bfloat16]
    assert tss.slstm_bwd_route(*_meta_bwd(shape, dtype)) == want


# xLSTM-1.3B trained (phase 10: 4 x 512 in bf16; the f32 unit) and the
# timed long shape
BWD_PATH_ROUTES = {"train_bf16": ((512, 4, 2048, 4), torch.bfloat16, tss.PERSISTENT),
                   "train_f32_unit": ((512, 4, 2048, 4), torch.float32, tss.PERSISTENT),
                   "smoke_f32": ((16, 4, 256, 4), torch.float32, tss.PERSISTENT),
                   "timed_long_bf16": (CS.SLSTM_LONG, torch.bfloat16, tss.PERSISTENT)}


@pytest.mark.parametrize("case", sorted(BWD_PATH_ROUTES))
def test_slstm_bwd_route_of_the_main_paths(case):
    shape, dtype, want = BWD_PATH_ROUTES[case]
    assert tss.slstm_bwd_route(*_meta_bwd(shape, dtype)) == want


def test_slstm_bwd_route_of_a_stacked_slot():
    """The cluster-stacked xLSTM runs B7 a slot on r[i], a view into the
    stacked (n, H, dh, 4dh) parameter at the train shape: its base stays
    16-byte aligned, so every slot takes the persistent backward."""
    dout = torch.empty((512, 4, 2048), dtype=torch.bfloat16, device="meta")
    stacked = torch.empty((2, 4, 512, 2048), dtype=torch.bfloat16)
    for i in range(2):
        assert stacked[i].is_contiguous() and stacked[i].data_ptr() % 16 == 0
        assert tss.slstm_bwd_route(dout, stacked[i]) == tss.PERSISTENT


def test_slstm_bwd_route_of_a_misaligned_r():
    dout = torch.zeros((4, 2, 80))
    flat = torch.zeros(2 * 40 * 160 + 4)
    off = next(i for i in range(1, 4) if (flat.data_ptr() + 4 * i) % 16)
    r = flat[off:off + 2 * 40 * 160].view(2, 40, 160)
    assert tss.slstm_bwd_route(dout, r) == tss.STEP
    assert tss.slstm_bwd_route(dout, r.clone()) == tss.PERSISTENT


@pytest.mark.parametrize("b,d,h,elt", [(4, 2048, 4, 2), (4, 2048, 4, 4), (4, 2048, 2, 2),
                                       (5, 96, 2, 4), (2, 612, 3, 4), (8, 4096, 8, 2),
                                       (3, 80, 2, 2), (4, 1536, 1, 2)])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_persistent_bwd_plan_fits_one_block_an_sm(b, d, h, elt, sms):
    plan = tss.persistent_bwd_plan(b, d, h, elt, sms, H100[1])
    if plan is None:
        return
    units, blocks, smem, r_elt = plan
    rows, dh = tss.persistent_rows(b), d // h
    assert (units, blocks) == tss.persistent_plan(b, d, h, elt, sms, 10 ** 9)[:2]
    assert units % tss.GROUP_UNITS == 0 and units * rows <= tss.PERSISTENT_THREADS
    assert blocks <= sms and (blocks - 1) * units < d <= blocks * units
    span = tss.persistent_bwd_span(d, dh, units)
    assert smem == tss.persistent_bwd_smem(dh, units, rows, span, r_elt) <= H100[1]
    # R in f32 wherever that fits
    assert r_elt == 4 or tss.persistent_bwd_smem(dh, units, rows, span, 4) > H100[1]


def test_persistent_bwd_plan_counts_the_heads_a_block_spans():
    """(24, 2, 612, 3): dh 204, blocks of 8 units, so the block of units
    200-207 straddles heads 0 and 1 and holds both heads' dz (2 x 4 rows x
    816 f32); at (4, 1536, 1) bf16 the forward fits but the backward's dz
    slice (4 rows x 6,144 f32, 96 KB) does not fit beside R's rows."""
    assert tss.persistent_bwd_span(612, 204, 8) == 2
    assert tss.persistent_bwd_span(2048, 512, 16) == 1
    assert tss.persistent_bwd_span(40, 20, 12) == 2
    units, blocks, smem, r_elt = tss.persistent_bwd_plan(2, 612, 3, 4, 132)
    assert (units, blocks, r_elt) == (8, 77, 4)
    assert smem == 8 * 816 * 4 + 2 * 4 * 816 * 4 + 2 * 8 * 16 * 4 + 2 * 7 * 8 * 4 * 4
    assert tss.persistent_plan(4, 1536, 1, 2, 132) is not None
    assert tss.persistent_bwd_plan(4, 1536, 1, 2, 132) is None
    rows_of_r, dz_slice = 12 * 4 * 1536 * 2, 4 * 4 * 1536 * 4
    assert rows_of_r <= H100[1] < rows_of_r + dz_slice             # the slice decides
    # the prefill shape: R's rows in f32 (128 KB) beside dz's 32 KB
    assert tss.persistent_bwd_plan(4, 2048, 4, 2, 132) == (16, 128, 168448, 4)
    assert tss.persistent_bwd_plan(4, 2048, 2, 2, 132)[3] == 2     # H 2: R kept in bf16
    assert tss.persistent_bwd_plan(4, 2048, 2, 4, 132) is None
    assert tss.persistent_bwd_plan(4, 2048, 1, 2, 132) is None
    assert tss.persistent_bwd_plan(9, 256, 4, 4, 132) is None
    assert tss.persistent_bwd_plan(2, 90, 3, 4, 132) is None


def test_persistent_bwd_constants_equal_the_source():
    text = (tbuild.CSRC / "slstm_scan_bwd_persistent.cu").read_text()
    for const, value in tss._BWD_PERSISTENT_CONSTANTS.items():
        assert re.findall(rf"constexpr int {const} = (\d+);", text) == [str(value)], const


# ---------------------------------------------------------------------------
# a CPU model of the persistent backward
# ---------------------------------------------------------------------------

def _gate_bwd(z, st, prev, g_h, carry):
    """One reverse step of every (row, unit) in f32 numpy, as
    slstm_gates.cuh's gate_prep and gate_apply compute it: z (4, B, d), the state (c,
    n, m) at t and at t - 1, g_h (B, d), the carry (dc, dn, dm) -> (dz (4,
    B, d), the carry of step t)."""
    one = np.float32(1)
    li, lf_raw, zz, oo = z
    _, c_t, n_t, m_t = st
    c_p, n_p, m_p = prev
    dc, dn, dm = carry
    lf = np.minimum(lf_raw, 0).astype(np.float32) - np.log1p(np.exp(-np.abs(lf_raw)))
    tz, so = np.tanh(zz), one / (one + np.exp(-oo))
    a = lf + m_p
    ig, fg = np.exp(li - m_t), np.exp(a - m_t)
    q = np.maximum(n_t, one)
    dp = g_h / q
    dq = -g_h * (so * c_t) / (q * q)
    dct = dc + dp * so
    dnt = dn + np.where(n_t >= one, dq, 0)
    doo = dp * c_t * so * (one - so)
    df = dct * c_p + dnt * n_p
    di = dct * tz + dnt
    dzz = dct * ig * (one - tz * tz)
    de_i, de_f = di * ig, df * fg
    dmt = dm - de_i - de_f
    to_a = np.where(a < li, 0, np.where(a == li, np.float32(0.5) * dmt, dmt))
    to_li = np.where(li < a, 0, np.where(a == li, np.float32(0.5) * dmt, dmt))
    da = de_f + to_a
    dz = np.stack([de_i + to_li, da / (one + np.exp(lf_raw)), dzz, doo]).astype(np.float32)
    return dz, tuple(x.astype(np.float32) for x in (dct * fg, dnt * fg, da))


def persistent_bwd_model(dout, r, z, state, n_heads, sms):
    """What slstm_bwd_persistent_kernel computes, block by block and warp by
    warp, in f32 numpy: dout (T, B, d), r (H, dh, 4dh), the forward's saves
    z (T, B, 4d) and state (4, T, B, d) -> dz (T, B, 4d)."""
    t_len, b, d = dout.shape
    dh = d // n_heads
    e4 = 4 * dh
    units, blocks, _, _ = tss.persistent_bwd_plan(b, d, n_heads, 4, sms)
    span = tss.persistent_bwd_span(d, dh, units)
    rows = tss.persistent_rows(b)
    groups = units // tss.GROUP_UNITS
    splits = max(1, 16 // groups)
    chunk = -(-dh // splits)
    lanes = np.arange(32)
    dz = np.zeros((t_len, b, 4 * d), np.float32)
    carry = tuple(np.zeros((b, d), np.float32) for _ in range(3))
    start = (np.zeros((b, d), np.float32), np.zeros((b, d), np.float32),
             np.full((b, d), tss.M_INIT, np.float32))
    for t in reversed(range(t_len)):
        rec = np.zeros((b, d), np.float32)
        if t < t_len - 1:
            seen = np.zeros(d, int)
            for blk in range(blocks):
                u0 = blk * units
                h_lo = u0 // dh
                for g in range(groups):
                    uq = u0 + g * tss.GROUP_UNITS
                    if uq >= d:
                        continue
                    head = uq // dh
                    assert head - h_lo < span                # within the block's dz slice
                    assert (uq + 3) // dh == head            # one head a group
                    zs = np.zeros((rows, e4), np.float32)
                    zs[:b] = dz[t + 1][:, head * e4:(head + 1) * e4]
                    w = r[head][uq - head * dh + np.arange(4)]          # (4 units, 4dh)
                    total = np.zeros(rows * 4, np.float32)
                    for s in range(splits):
                        lo, hi = s * chunk, min(dh, (s + 1) * chunk)
                        partial = np.zeros((32, rows, 4), np.float32)
                        for c0 in range(lo, hi, 32):                    # lane l: c = c0 + l
                            cs = c0 + lanes
                            live = cs < hi
                            for qd in range(4):                         # the chunk's 4 e's
                                e = 4 * np.where(live, cs, 0) + qd
                                term = zs[:, e].T[:, :, None] * w[:, e].T[:, None, :]
                                partial += np.where(live[:, None, None], term, 0)
                        total = total + _butterfly(partial.reshape(32, rows * 4))
                    rec[:, uq:uq + 4] = total.reshape(rows, 4)[:b]
                    seen[uq:uq + 4] += 1
            assert (seen == 1).all()
        g_h = dout[t] + rec
        prev = tuple(state[1:, t - 1]) if t else start
        dzt, carry = _gate_bwd(z[t].reshape(b, 4, d).transpose(1, 0, 2), state[:, t], prev,
                               g_h, carry)
        dz[t] = dzt.transpose(1, 0, 2).reshape(b, 4 * d)
    return dz


# (T, B, d, H, the stand-in's SMs): blocks straddling two heads (dh 24 in
# blocks of 16; dh 20 in blocks of 12, a dead last group), 8 rows (B 5) with
# 3 groups a block (5 ranges of e), one group a block (16 ranges), B 1, T 1
BWD_MODEL_CASES = {"h4_b3_straddle": (12, 3, 96, 4, 7), "h2_b5_ragged": (10, 5, 80, 2, 9),
                   "h1_b2": (8, 2, 64, 1, 132), "h2_b4_straddle_dead": (9, 4, 40, 2, 4),
                   "h4_b1": (6, 1, 32, 4, 132), "t1": (1, 2, 32, 2, 132)}


@pytest.mark.parametrize("case", sorted(BWD_MODEL_CASES))
def test_persistent_bwd_model_matches_plain_and_reference(case):
    t, b, d, h, sms = BWD_MODEL_CASES[case]
    pre, r = _model_inputs(t, b, d, h, seed=100 + len(case))
    w = np.random.default_rng(len(case)).normal(size=(t, b, d)).astype(np.float32)
    tp, tr, tw = (torch.from_numpy(a) for a in (pre, r, w))
    _, z, state = tss.slstm_scan_saving_plain(tp, tr, h)
    got = persistent_bwd_model(w, r, z.numpy(), state.numpy(), h, sms)
    plain = tss.slstm_scan_bwd_plain(tw, tr, z, state, h).numpy()
    np.testing.assert_allclose(got, plain, atol=MODEL_ATOL, rtol=0)

    def loss(p, rr):
        return jnp.sum(ref.slstm_scan_reference(p, rr, n_heads=h) * w)

    dpre, dr = jax.grad(loss, argnums=(0, 1))(jnp.asarray(pre), jnp.asarray(r))
    np.testing.assert_allclose(got, np.asarray(dpre), atol=MODEL_ATOL, rtol=0)
    got_dr = tss.recurrent_weight_grad(state[0], torch.from_numpy(got), h).numpy()
    np.testing.assert_allclose(got_dr, np.asarray(dr), atol=MODEL_ATOL, rtol=0)
