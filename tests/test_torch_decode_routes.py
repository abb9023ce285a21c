"""B6's routes and B3's reduction order, on the CPU.

  * ``decode_route``: Qwen3-8B's serve and decode_32k shapes in bf16 take
    the tensor cores (``csrc/decode_attention_tc.cu``); f32, head dims 32,
    80 and 256 and a misaligned view take the f32-FMA kernel.
  * The tensor-core kernel's split: a cluster of ``splits`` blocks, block
    ``rank`` taking keys [begin + rank * chunk, + chunk) clipped to the live
    range, visits every live key exactly once, for a host index (the split
    sized over the live keys) and a device index (sized over the cache or
    window: blocks past the live range visit nothing).
  * The tolerance argument for the tensor-core route: a plain emulation of
    its numerics (4 warps of 16 keys a 64-key stage, each its own online
    softmax from -1e30, P rounded to bf16 for P V, f32 accumulation, the
    warps merged in warp order and the cluster's blocks in rank order) held
    against ``repro.kernels.decode_attention`` in interpret mode and the
    ``ref.py`` oracle within the card's bf16 bound (``chip_smoke.ATTN_ATOL``
    2e-2): GQA groups 1/4/8, MQA, 32 heads a KV head, windows, index 0 and
    S - 1, both index forms.
  * B3's stats kernel's reduction order: an emulation of its layout
    (``stats_layout``: a cluster of row chunks x 256-column segment chunks,
    a warp a row, 8 columns a lane; the row maxima over the column chunks;
    column sums by warp in row order, then in warp order, then over the row
    chunks in rank order; each row's distance partials by lane butterflies,
    then in column-chunk order, their square roots in row order; the norms
    by thread, butterfly, warp and rank order) held against
    ``repro.kernels.quant_exchange.quant_dequant_stats`` in interpret mode:
    deq and scales bit-equal, the stats within rtol 1e-5 (the kernel's sums
    run in another order than the Pallas kernel's).
  * The Python copies of both kernels' tile, cluster and layout constants
    equal the sources' ``constexpr`` values, and ``build.check_constants``
    (what the launchers run on the card) refuses a library whose own differ.
"""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import quant_exchange as tqx
from _torch_threads import one_thread  # noqa: F401

ATTN_BF16_ATOL = 2e-2           # chip_smoke.ATTN_ATOL["bfloat16"]
STATS_RTOL = 1e-5
FORMATS = ("int8", "fp8_e4m3")


SMS = 132                       # an H100's streaming multiprocessors


def _resident(splits):
    """A stand-in for the card's answer (cudaOccupancyMaxActiveClusters):
    two blocks an SM over an H100's 132 SMs."""
    return 2 * SMS // splits


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


# (q shape, cache shape, dtype) -> route
DECODE_ROUTES = {
    "qwen3_8b_serve_bf16": ((4, 1, 32, 128), (4, 512, 8, 128), torch.bfloat16,
                            tfa.TENSOR_CORES),
    "decode_32k_bf16": ((8, 1, 32, 128), (8, 32768, 8, 128), torch.bfloat16,
                        tfa.TENSOR_CORES),
    "d64_mqa_bf16": ((2, 1, 8, 64), (2, 300, 1, 64), torch.bfloat16, tfa.TENSOR_CORES),
    "qwen3_8b_serve_f32": ((4, 1, 32, 128), (4, 512, 8, 128), torch.float32, tfa.F32_FMA),
    "d32_bf16": ((1, 1, 2, 32), (1, 128, 1, 32), torch.bfloat16, tfa.F32_FMA),
    "d80_bf16": ((1, 1, 4, 80), (1, 1000, 2, 80), torch.bfloat16, tfa.F32_FMA),
    "d256_bf16": ((2, 1, 16, 256), (2, 257, 8, 256), torch.bfloat16, tfa.F32_FMA),
}


@pytest.mark.parametrize("case", sorted(DECODE_ROUTES))
def test_decode_route(case):
    qs, kvs, dtype, want = DECODE_ROUTES[case]
    assert tda.decode_route(_meta(qs, dtype), _meta(kvs, dtype), _meta(kvs, dtype)) == want


def test_decode_route_of_a_misaligned_view():
    """A contiguous cache view whose base lies 2 bytes past a 16-byte
    boundary cannot be read by 16-byte copies."""
    shape = (2, 16, 2, 64)
    flat = torch.zeros(math.prod(shape) + 8, dtype=torch.bfloat16)
    off = next(i for i in range(1, 8) if (flat.data_ptr() + 2 * i) % 16)
    k = flat[off:off + math.prod(shape)].view(shape)
    assert k.is_contiguous() and k.data_ptr() % 16 != 0
    q = torch.zeros((2, 1, 4, 64), dtype=torch.bfloat16)
    aligned = torch.zeros(shape, dtype=torch.bfloat16)
    assert tda.decode_route(q, k, aligned) == tfa.F32_FMA
    assert tda.decode_route(q, aligned, aligned) == tfa.TENSOR_CORES


def test_check_index_takes_an_int_or_a_0d_int32_tensor():
    q = torch.zeros((1, 1, 2, 64))
    assert tda._check_index(5, 8, q) == (None, 5)
    t = torch.tensor(5, dtype=torch.int32)
    assert tda._check_index(t, 8, q) == (t.data_ptr(), 0)
    for bad in (torch.tensor(5), torch.tensor([5], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            tda._check_index(bad, 8, q)
    for bad in (-1, 8):
        with pytest.raises(ValueError, match="0 <= index < S"):
            tda._check_index(bad, 8, q)


def _tc_split(index, window, s, clusters, device_index):
    """(chunk, splits, [(lo, hi) per rank]) as the launcher picks the split
    and each block of decode_tc_kernel computes its keys."""
    begin, end = tda.live_range(index, window)
    n_keys = tda.span(s, window) if device_index else end - begin
    chunk, splits = tda.decode_tc_splits(n_keys, clusters, SMS, _resident)
    ranges = []
    for rank in range(splits):
        lo = begin + rank * chunk
        ranges.append((lo, min(end, lo + chunk)))
    return chunk, splits, ranges


@pytest.mark.parametrize("device_index", [False, True])
@pytest.mark.parametrize("s,window,clusters", [(512, 0, 32), (32768, 0, 64), (300, 0, 2),
                                               (1000, 100, 2), (257, 1024, 16), (37, 0, 2),
                                               (64, 16, 1), (5000, 0, 600)])
def test_tc_split_visits_every_live_key_once(s, window, clusters, device_index):
    for index in sorted({0, 1, 15, 63, 64, s // 2, s - 2, s - 1}):
        if not 0 <= index < s:
            continue
        chunk, splits, ranges = _tc_split(index, window, s, clusters, device_index)
        assert chunk % tda.TC_TILE_KEYS == 0 and 1 <= splits <= tda.TC_MAX_SPLITS
        assert clusters * splits <= SMS and clusters <= _resident(splits) or splits == 1
        begin, end = tda.live_range(index, window)
        seen = [key for lo, hi in ranges for key in range(lo, hi)]
        assert seen == list(range(begin, end))            # each once, in rank order
        if not device_index:
            assert all(lo < hi for lo, hi in ranges)      # no idle block
        # a block past the live range reads nothing
        assert all(hi <= lo for lo, hi in ranges if lo >= end)


def test_tc_splits_give_each_sm_one_block_at_most():
    assert tda.decode_tc_splits(480, 32, SMS, _resident) == (128, 4)     # the serve shape
    assert tda.decode_tc_splits(32768, 64, SMS, _resident) == (16384, 2)  # decode_32k, 8 seqs
    assert tda.decode_tc_splits(37, 2, SMS, _resident) == (64, 1)
    assert tda.decode_tc_splits(100000, 1000, SMS, _resident) == (100032, 1)
    # clusters that would not all fit at once take fewer splits
    assert tda.decode_tc_splits(512, 16, SMS, lambda s: 8 // s) == (512, 1)


def _tc_decode_emulation(q, k, v, index, window, device_index):
    """decode_tc_kernel's numerics in plain PyTorch: per block, 4 warps each
    take 16 keys of every 64-key stage with their own online softmax (f32
    scores, the running max from -1e30, masked scores -inf, P rounded to
    bf16 for P V, l over the f32 P); the warps merged in warp order, the
    blocks in rank order, divided by max(l, 1e-30)."""
    b, _, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float()[:, 0].reshape(b, hkv, g, d)
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)       # (B, Hkv, S, D)
    scale = 1.0 / math.sqrt(d)
    clusters = b * hkv * -(-g // tda.TC_HEADS)
    _, _, ranges = _tc_split(index, window, s, clusters, device_index)

    def merge(states):
        big = torch.full(states[0][0].shape, -1e30)
        for m, _, _ in states:
            big = torch.maximum(big, m)
        tot_l, tot_a = torch.zeros_like(big), torch.zeros(big.shape + (d,))
        for m, l, a in states:
            c = torch.exp(m - big)
            tot_l = tot_l + l * c
            tot_a = tot_a + a * c[..., None]
        return big, tot_l, tot_a

    blocks = []
    for lo, hi in ranges:
        warps = []
        for w in range(4):
            m = torch.full((b, hkv, g), -1e30)
            l, acc = torch.zeros_like(m), torch.zeros((b, hkv, g, d))
            for t0 in range(lo, hi, tda.TC_TILE_KEYS):
                keys = torch.arange(t0 + 16 * w, t0 + 16 * w + 16)
                live = keys < hi
                kk = keys.clamp(max=s - 1)
                kt = torch.where(live[:, None], kf[:, :, kk], 0.0)      # zero-filled rows
                vt = torch.where(live[:, None], vf[:, :, kk], 0.0)
                sc = torch.einsum("bhgd,bhkd->bhgk", qf, kt) * scale
                sc = torch.where(live, sc, torch.tensor(-math.inf))
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vt
                m = m_new
            warps.append((m, l, acc))
        blocks.append(merge(warps))
    _, l, acc = merge(blocks)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(torch.bfloat16)


# (B, S, H, Hkv, D, window): the serve shape cut (group 4), groups 1 and 8,
# MQA, 32 heads a KV head (two 16-head chunks), windows, D 64 and 128
TC_DECODE_CASES = {"serve_cut": (2, 512, 8, 2, 128, 0), "group1": (2, 256, 4, 4, 64, 0),
                   "group8": (1, 256, 16, 2, 64, 0), "mqa": (2, 384, 8, 1, 64, 0),
                   "group32": (1, 256, 32, 1, 64, 0), "window100": (1, 512, 4, 2, 128, 100),
                   "window16": (2, 256, 8, 2, 64, 16)}


@pytest.mark.parametrize("device_index", [False, True])
@pytest.mark.parametrize("case", sorted(TC_DECODE_CASES))
def test_tc_numerics_match_the_pallas_kernel_within_the_bf16_bound(case, device_index):
    b, s, h, hkv, d, window = TC_DECODE_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    for index in (0, s // 2 + 3, s - 1):
        got = _tc_decode_emulation(q, k, v, index, window, device_index)
        pallas = jops.decode_attention(jq, jk, jv, jnp.int32(index), window=window,
                                       block_k=128, interpret=True)
        oracle = ref.decode_attention_reference(
            *(x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], d) for x in (jq, jk, jv)),
            index, window=window)
        oracle = np.asarray(oracle, np.float32).reshape(b, h, 1, d).transpose(0, 2, 1, 3)
        plain = tda.decode_attention_plain(q, k, v, index, window=window)
        for want in (np.asarray(pallas, np.float32), oracle, plain.float().numpy()):
            err = float(np.abs(got.float().numpy() - want).max())
            assert err <= ATTN_BF16_ATOL, (index, err)


def test_tc_emulation_ignores_the_stale_cache():
    """Keys past the live range (stale cache, here huge) change nothing,
    whether the split covers the live keys or the whole cache."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((1, 1, 4, 64), (1, 200, 2, 64), (1, 200, 2, 64)))
    stale_k, stale_v = k.clone(), v.clone()
    stale_k[:, 51:], stale_v[:, 51:] = 1e4, -1e4
    for device_index in (False, True):
        assert torch.equal(_tc_decode_emulation(q, stale_k, stale_v, 50, 0, device_index),
                           _tc_decode_emulation(q, k, v, 50, 0, device_index))


# --- B3: the stats kernel's layout and reduction order ----------------------

def _lane_cols(segs, vec):
    """(32, 8 * segs): the column of each lane's values from the block's
    first column (qdq_stats_kernel's stats_col)."""
    i = torch.arange(tqx.STATS_SEG_COLS // 32 * segs)
    lane = torch.arange(32)[:, None]
    seg, slot = i // 8, i % 8
    if vec:
        return seg * tqx.STATS_SEG_COLS + (slot >> 2) * 128 + lane * 4 + (slot & 3)
    return seg * tqx.STATS_SEG_COLS + slot * 32 + lane


def _butterfly(a):
    """warp_sum over the last dim (32 lanes): xor shuffles 16, 8, 4, 2, 1."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        a = a + a[..., lanes ^ o]
    return a[..., 0]


def _seq_sum(a, dim):
    """f32 sum in index order along ``dim``, from 0."""
    out = torch.zeros_like(a.select(dim, 0))
    for j in range(a.shape[dim]):
        out = out + a.select(dim, j)
    return out


def _stats_emulation(x, fmt):
    """One message (N, D) through qdq_stats_kernel's layout and order:
    (deq, scales, stats).  Products and sums in f32, each on its own (the
    kernel's nvcc may fuse a multiply and an add)."""
    n, d = x.shape
    row_blocks, col_blocks, segs, rows = tqx.stats_layout(n, d)
    cols = segs * tqx.STATS_SEG_COLS
    lanes = _lane_cols(segs, d % 4 == 0)
    warps = tqx.STATS_WARPS

    def per_lane(a):              # (N, D) -> (N, col_blocks, 32, values a lane)
        pad = torch.zeros((a.shape[0], col_blocks * cols))
        pad[:, :d] = a
        return pad.reshape(a.shape[0], col_blocks, cols)[:, :, lanes]

    # the rows' maxima: each block's by lane and butterfly, then over the
    # column chunks (a max: exact in any order)
    amax = per_lane(x.abs()).amax(dim=(-1, -2)).amax(-1)
    scale = torch.clamp_min(amax, 1e-12) * tqx.QINV[fmt]
    deq, want_scale = tqx.quant_dequant_plain(x, fmt)
    assert torch.equal(scale, want_scale)
    v = per_lane(deq)                                         # (N, col_blocks, 32, kv)
    chunks = [range(rr * rows, min(n, (rr + 1) * rows)) for rr in range(row_blocks)]
    # column sums: a block's warp w over its rows w, w + 16, ... in order,
    # the block's in warp order, the means over the row chunks in rank order
    bsum = []
    for chunk in chunks:
        colp = torch.zeros((warps,) + v.shape[1:])
        for i, r in enumerate(chunk):
            colp[i % warps] = colp[i % warps] + v[r]
        bsum.append(_seq_sum(colp, 0))
    mu_lane = _seq_sum(torch.stack(bsum), 0) / n              # (col_blocks, 32, kv)
    mu = torch.zeros((col_blocks, cols))
    mu[:, lanes] = mu_lane
    # parts (mu^2, min(v, 0)^2, v^2, distances) of each block, rank order
    parts = torch.zeros((row_blocks, col_blocks, 4))
    # mu^2 by the row chunk 0 blocks: thread t over columns t, t + 512, ...;
    # butterfly; warp order
    mu_t = torch.zeros((col_blocks, warps * 32))
    for c0 in range(0, cols, warps * 32):
        part = mu[:, c0:c0 + warps * 32]
        mu_t[:, :part.shape[1]] = mu_t[:, :part.shape[1]] + part * part
    parts[0, :, 0] = _seq_sum(_butterfly(mu_t.reshape(col_blocks, warps, 32)), 1)
    # each row's sum (v - mu)^2: lane over its values, butterfly; the column
    # chunks in order; square roots summed over the chunk's rows in order by
    # column chunk 0
    dev = v - mu_lane
    dist = torch.sqrt(_seq_sum(_butterfly(_seq_sum(dev * dev, -1)), 1))   # (N,)
    for rr, chunk in enumerate(chunks):
        parts[rr, 0, 3] = _seq_sum(dist[chunk.start:chunk.stop], 0)
        # the norms: thread (warp, lane) over its rows in order, each over
        # its values in order; butterfly; warp order
        neg_t = torch.zeros((warps,) + v.shape[1:3])
        tot_t = torch.zeros_like(neg_t)
        for i, r in enumerate(chunk):
            for j in range(v.shape[-1]):
                val = v[r, :, :, j]
                neg = torch.clamp_max(val, 0.0)
                neg_t[i % warps] = neg_t[i % warps] + neg * neg
                tot_t[i % warps] = tot_t[i % warps] + val * val
        parts[rr, :, 1] = _seq_sum(_butterfly(neg_t), 0)
        parts[rr, :, 2] = _seq_sum(_butterfly(tot_t), 0)
    mu_sq, neg_sq, tot_sq, dist_sum = _seq_sum(parts.reshape(-1, 4), 0)
    mu_norm = torch.clamp_min(torch.sqrt(mu_sq), 1e-12)
    total = torch.clamp_min(torch.sqrt(tot_sq), 1e-12)
    stats = torch.stack([(dist_sum / n) / mu_norm, torch.sqrt(neg_sq) / total])
    return deq, scale, stats


@pytest.mark.parametrize("n", [1, 3, 8, 37, 64, 320, 1024, 8192])
@pytest.mark.parametrize("d", [1, 32, 200, 255, 256, 257, 1000, 2048, 2049, 4096, 6000,
                               8192])
def test_stats_layout_covers_every_row_and_column_once(n, d):
    row_blocks, col_blocks, segs, rows = tqx.stats_layout(n, d)
    assert 1 <= row_blocks * col_blocks <= tqx.STATS_MAX_BLOCKS and segs in (1, 2, 4)
    assert (row_blocks - 1) * rows < n <= row_blocks * rows
    cols = segs * tqx.STATS_SEG_COLS
    assert (col_blocks - 1) * cols < d <= col_blocks * cols
    for vec in (False, True):
        lanes = _lane_cols(segs, vec)
        every = torch.cat([rank * cols + lanes.flatten() for rank in range(col_blocks)])
        assert sorted(every.tolist()) == list(range(col_blocks * cols))


def test_stats_layout_spreads_the_main_path_over_eight_blocks():
    assert tqx.stats_layout(64, 256) == (8, 1, 1, 8)          # a row a warp, 8 SMs
    assert tqx.stats_layout(3, 8192) == (1, 8, 4, 3)
    assert tqx.stats_layout(1024, 4096) == (1, 8, 2, 1024)


def test_stats_layout_refuses_what_the_wide_path_takes():
    with pytest.raises(ValueError, match="1 to 8192 columns"):
        tqx.stats_layout(4, tqx.MAX_STATS_D + 1)
    with pytest.raises(ValueError, match="1 to 8192 rows"):
        tqx.stats_layout(tqx.MAX_STATS_ROWS + 1, 256)


def _stats_message(shape, seed):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape) - 0.3, 0.0) * rng.uniform(0.01, 10.0,
                                                                   size=shape[:-1] + (1,))
    x[..., : max(1, shape[-1] // 8)] -= 0.5
    if shape[-2] > 2:
        x[..., 1, :] = 0.0
    return x.astype(np.float32)


# the sequential and batched main paths' messages, then D 1,000 and 8,192 at
# n 1 and 3, a ragged width (lane-strided loads) and B3's edge (64, 32)
STATS_CASES = {"seq_64x256": (64, 256), "batched_5x64x256": (5, 64, 256),
               "n1_d1000": (1, 1000), "n3_d1000": (3, 1000), "n1_d8192": (1, 8192),
               "n3_d8192": (3, 8192), "n37_d201": (37, 201), "n64_d32": (64, 32),
               "n20_d1000": (20, 1000)}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_stats_order_matches_the_pallas_kernel(case, fmt):
    shape = STATS_CASES[case]
    x = _stats_message(shape, seed=len(case))
    for msg in x.reshape((-1,) + shape[-2:]):
        deq, scale, stats = _stats_emulation(torch.from_numpy(msg), fmt)
        jd, js, jst = jops.quant_roundtrip_stats(jnp.asarray(msg), fmt, interpret=True)
        np.testing.assert_array_equal(deq.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
        np.testing.assert_allclose(stats.numpy(), np.asarray(jst), rtol=STATS_RTOL, atol=0)


# the Python copies of each library's constants (what decode_tc_splits,
# stats_layout, B2's row_layout and wide_layout (tests/test_torch_routes.py)
# and the emulations above use): the launcher checks them
# against the library's repro_<name>_constants on the card; here they are
# held against the sources' constexpr lines
CONSTANTS = {"decode_attention_tc": tda._TC_CONSTANTS, "quant_exchange": tqx._CONSTANTS}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_python_constants_equal_the_sources(name):
    text = (tbuild.CSRC / f"{name}.cu").read_text()
    for const, value in CONSTANTS[name].items():
        found = re.findall(rf"constexpr int {const} = (\d+);", text)
        assert found == [str(value)], (name, const, found)


class _FakeLibrary:
    """Stands in for a loaded library whose repro_<name>_constants writes
    ``values``."""

    def __init__(self, name, values):
        def write(addr):
            out = (ctypes.c_int * len(values)).from_address(addr)
            out[:] = values
            return 0
        setattr(self, f"repro_{name}_constants", write)


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_check_constants_refuses_a_library_that_differs(name, monkeypatch):
    expected = CONSTANTS[name]
    good, bad = list(expected.values()), [v + 1 for v in expected.values()]
    monkeypatch.setattr(tbuild, "_CHECKED", set())
    monkeypatch.setattr(tbuild, "load", lambda n: _FakeLibrary(name, bad))
    with pytest.raises(RuntimeError, match="differ from the launcher's copies"):
        tbuild.check_constants(name, expected)
    assert name not in tbuild._CHECKED
    monkeypatch.setattr(tbuild, "load", lambda n: _FakeLibrary(name, good))
    tbuild.check_constants(name, expected)
    assert name in tbuild._CHECKED
    monkeypatch.setattr(tbuild, "load", lambda n: _FakeLibrary(name, bad))
    tbuild.check_constants(name, expected)            # checked once a process
