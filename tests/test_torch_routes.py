"""The port's kernel routes and B3's wide path, on the CPU.

  * B3 (``quant_dequant_stats``) and B2 (``quant_dequant``) at widths past
    the one-block kernels' 8,192 columns, which the card runs on the wide
    path: the plain version (what a CPU tensor takes and what
    ``chip_smoke.py`` holds the wide kernels against) against the
    reference's Pallas kernel in interpret mode: deq and scales bit-equal,
    stats within rtol 1e-5 (two f32 summation orders over up to 80,000
    terms).
  * The route choosers of B5's and B4's forwards (``attention_route``,
    ``xent_route``): Qwen3-8B's serve and train shapes in bf16 take the
    tensor cores; f32, head dims 32 and 80, a vocab of 151,937 and a
    misaligned view take the f32-FMA kernel.
  * The tolerance argument for B5's tensor-core route: a plain emulation of
    its numerics (128-row query blocks, 128- or 64-key tiles, the online
    softmax in base 2, P rounded to bf16 before P V, f32 accumulation) stays
    within the card's bf16 bound (``chip_smoke.ATTN_ATOL``, 2e-2) of
    ``flash_attention_plain``, and its log-sum-exp within 1e-4 of the exact
    one.
  * ``build.library_path`` hashes the headers a source includes.
"""
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_xent as tfx
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_exchange as tqx
from _torch_threads import one_thread  # noqa: F401

FORMATS = ("int8", "fp8_e4m3")
STATS_RTOL = 1e-5
ATTN_BF16_ATOL = 2e-2           # chip_smoke.ATTN_ATOL["bfloat16"]
WIDE_CASES = {"n4_d12288": (4, 12288), "n8_d20000": (8, 20000),
              "batched_3x4x10000": (3, 4, 10000)}


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


def _wide_message(shape, seed):
    """Cut-activation-like rows of varied scale, one all-zero row (the
    scale's eps path), a little mass below zero."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape) - 0.3, 0.0) * rng.uniform(0.01, 10.0,
                                                                   size=shape[:-1] + (1,))
    x[..., : shape[-1] // 8] -= 0.5
    x[..., 1, :] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_stats_match_the_pallas_kernel(case, fmt):
    shape = WIDE_CASES[case]
    assert shape[-1] > tqx.MAX_STATS_D              # the card's wide path
    x = _wide_message(shape, seed=len(case))
    td, ts, tst = tops.quant_roundtrip_stats(torch.from_numpy(x), fmt)
    assert td.shape == shape and ts.shape == shape[:-1] and tst.shape == shape[:-2] + (2,)
    for i, msg in enumerate(x.reshape((-1,) + shape[-2:])):
        jd, js, jst = jops.quant_roundtrip_stats(jnp.asarray(msg), fmt, interpret=True)
        got = [t.reshape((-1,) + t.shape[len(shape) - 2:])[i] for t in (td, ts, tst)]
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(js))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(jst), rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ["n4_d12288", "n8_d20000"])
def test_wide_roundtrip_matches_the_pallas_kernel(case, fmt):
    x = _wide_message(WIDE_CASES[case], seed=len(case) + 1)
    jd, js = jops.quant_roundtrip(jnp.asarray(x), fmt, interpret=True)
    td, ts = tops.quant_roundtrip(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_wide_launchers_take_any_width_on_cuda_only():
    """No width cap is left on the launchers: a wide CPU message is refused
    for its device, not its width."""
    for launcher in (tqx.quant_dequant, tqx.quant_dequant_stats):
        with pytest.raises(ValueError, match="CUDA"):
            launcher(torch.zeros((4, 2 * tqx.MAX_STATS_D + 1)), "int8")


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous view whose base lies 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(math.prod(shape) + 8, dtype=dtype)
    off = next(i for i in range(1, 8) if (flat.data_ptr() + i * flat.element_size()) % 16)
    view = flat[off:off + math.prod(shape)].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# (q shape, kv shape, dtype) -> route
ATTN_ROUTES = {
    "qwen3_8b_serve_bf16": ((4, 480, 32, 128), (4, 480, 8, 128), torch.bfloat16,
                            tfa.TENSOR_CORES),
    "qwen3_8b_train_bf16": ((4, 512, 32, 128), (4, 512, 8, 128), torch.bfloat16,
                            tfa.TENSOR_CORES),
    "prefill_8k_bf16": ((1, 8192, 32, 128), (1, 8192, 8, 128), torch.bfloat16,
                        tfa.TENSOR_CORES),
    "d64_mqa_bf16": ((2, 128, 8, 64), (2, 128, 1, 64), torch.bfloat16, tfa.TENSOR_CORES),
    "d256_bf16": ((1, 300, 16, 256), (1, 300, 8, 256), torch.bfloat16, tfa.TENSOR_CORES),
    "qwen3_8b_serve_f32": ((4, 480, 32, 128), (4, 480, 8, 128), torch.float32,
                           tfa.F32_FMA),
    "d80_bf16": ((2, 37, 4, 80), (2, 37, 2, 80), torch.bfloat16, tfa.F32_FMA),
    "d32_bf16": ((1, 256, 2, 32), (1, 256, 2, 32), torch.bfloat16, tfa.F32_FMA),
}


@pytest.mark.parametrize("case", sorted(ATTN_ROUTES))
def test_attention_route(case):
    qs, kvs, dtype, want = ATTN_ROUTES[case]
    q, k, v = _meta(qs, dtype), _meta(kvs, dtype), _meta(kvs, dtype)
    assert tfa.attention_route(q, k, v) == want


def test_attention_route_of_a_misaligned_view():
    q, k = _misaligned((2, 16, 4, 64)), _misaligned((2, 16, 2, 64))
    aligned = torch.zeros((2, 16, 2, 64), dtype=torch.bfloat16)
    assert tfa.attention_route(q, aligned, aligned) == tfa.F32_FMA
    assert tfa.attention_route(torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16), k,
                               aligned) == tfa.F32_FMA
    assert tfa.attention_route(torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16), aligned,
                               aligned) == tfa.TENSOR_CORES


# (h shape, W shape, dtype) -> route
XENT_ROUTES = {
    "qwen3_8b_train_bf16": ((2048, 4096), (4096, 151936), torch.bfloat16, tfx.TENSOR_CORES),
    "t333_bf16": ((333, 1024), (1024, 151936), torch.bfloat16, tfx.TENSOR_CORES),
    "d80_v1000_bf16": ((37, 80), (80, 1000), torch.bfloat16, tfx.TENSOR_CORES),
    "qwen3_8b_train_f32": ((2048, 4096), (4096, 151936), torch.float32, tfx.F32_FMA),
    "v151937_bf16": ((129, 256), (256, 151937), torch.bfloat16, tfx.F32_FMA),
    "v7_bf16": ((1, 64), (64, 7), torch.bfloat16, tfx.F32_FMA),
    "d36_bf16": ((8, 36), (36, 64), torch.bfloat16, tfx.F32_FMA),
}


@pytest.mark.parametrize("case", sorted(XENT_ROUTES))
def test_xent_route(case):
    hs, ws, dtype, want = XENT_ROUTES[case]
    assert tfx.xent_route(_meta(hs, dtype), _meta(ws, dtype)) == want


def test_xent_route_of_a_misaligned_view():
    w = torch.zeros((64, 256), dtype=torch.bfloat16)
    assert tfx.xent_route(_misaligned((8, 64)), w) == tfx.F32_FMA
    assert tfx.xent_route(torch.zeros((8, 64), dtype=torch.bfloat16),
                          _misaligned((64, 256))) == tfx.F32_FMA


@pytest.mark.parametrize("t,v,sms", [(2048, 151936, 132), (333, 151936, 132),
                                     (37, 1000, 132), (8192, 151936, 132), (1, 8, 16)])
def test_tensor_core_forward_grid_covers_every_panel(t, v, sms):
    per_block, nsplit = tfx.xent_splits(t, v, sms, tfx.PANEL_V_TC, 1)
    n_panels = -(-v // tfx.PANEL_V_TC)
    assert per_block >= 1 and (nsplit - 1) * per_block < n_panels <= nsplit * per_block
    assert nsplit <= 65535


def _tc_emulation(q, k, v, window):
    """B5's tensor-core numerics in plain PyTorch: 128-row query blocks,
    key tiles of 128 (D <= 128) or 64, each tile's scores in f32 scaled
    into base 2, the running max from -1e30, masked scores -inf, P rounded
    to bf16 for P V with f32 accumulation and l summed over the f32 P.
    Returns (out bf16 (B, Sq, H, D), lse (B, H, Sq) f32)."""
    b, sq, h, d = q.shape
    sk, groups = k.shape[1], h // k.shape[2]
    bk = 128 if d <= 128 else 64
    qf = q.float().transpose(1, 2)                                   # (B, H, S, D)
    kf = k.float().repeat_interleave(groups, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(groups, dim=2).transpose(1, 2)
    scale2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    out = torch.empty((b, h, sq, d))
    lse = torch.empty((b, h, sq))
    for q0 in range(0, sq, 128):
        rows = torch.arange(q0, min(sq, q0 + 128))
        m = torch.full((b, h, rows.numel()), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, rows.numel(), d))
        k_end = min(sk, q0 + 128)
        k_begin = max(0, q0 - window + 1) if window else 0
        for kt in range(k_begin, k_end, bk):
            keys = torch.arange(kt, min(kt + bk, k_end))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            live = tfa.causal_mask(rows, keys, window)
            s = torch.where(live, s * scale2, torch.tensor(-math.inf))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, keys]
            m = m_new
        denom = torch.clamp_min(l, 1e-30)
        out[:, :, rows] = acc / denom[..., None]
        lse[:, :, rows] = m * math.log(2.0) + torch.log(denom)
    return out.transpose(1, 2).to(torch.bfloat16), lse


# (B, S, H, Hkv, D, window): the serve shape with B and H cut, a window, D 64
# and 256 (64-key tiles), ragged S
TC_CASES = {"serve_cut": (2, 480, 8, 2, 128, 0), "window64": (1, 300, 4, 2, 128, 64),
            "d64_mqa": (2, 200, 4, 1, 64, 0), "d256_window": (1, 300, 4, 2, 256, 128),
            "s37": (2, 37, 4, 2, 64, 0)}


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_tensor_core_numerics_stay_within_the_bf16_bound(case):
    b, s, h, hkv, d, window = TC_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got, lse = _tc_emulation(q, k, v, window)
    want = tfa.flash_attention_plain(q, k, v, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert 0.0 < err <= ATTN_BF16_ATOL, err
    # the exact log-sum-exp of the scaled scores, which the backward reads
    mask = tfa.causal_mask(torch.arange(s), torch.arange(s), window)
    kf = k.float().repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(d)
    exact = torch.logsumexp(torch.where(mask, scores, torch.tensor(-math.inf)), dim=-1)
    assert float((lse - exact).abs().max()) <= 1e-4


def test_library_path_follows_the_included_headers(tmp_path, monkeypatch):
    """Editing a header (sm90.cuh, xent_combine.cuh, slstm_gates.cuh,
    grid_sync.cuh, persistent_scan.cuh) renames the libraries of the sources
    that include it (the four tensor-core sources include sm90.cuh, B7's
    four kernels slstm_gates.cuh, its two persistent ones persistent_scan.cuh),
    and only theirs; nothing is compiled."""
    monkeypatch.setattr(tbuild, "_nvcc", lambda: pytest.fail("nvcc was called"))
    csrc = tmp_path / "csrc"
    shutil.copytree(tbuild.CSRC, csrc)
    before = {name: tbuild.library_path(name, csrc) for name in tbuild.SOURCES}
    assert before == {name: tbuild.library_path(name) for name in tbuild.SOURCES}
    with open(csrc / "sm90.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {name: tbuild.library_path(name, csrc) for name in tbuild.SOURCES}
    changed = {name for name in tbuild.SOURCES if after[name] != before[name]}
    assert changed == {"flash_attention_tc", "fused_xent_tc", "flash_attention_bwd_tc",
                       "fused_xent_bwd_tc"}
    with open(csrc / "xent_combine.cuh", "a") as f:
        f.write("\n// edited\n")
    again = {name: tbuild.library_path(name, csrc) for name in tbuild.SOURCES}
    assert {name for name in tbuild.SOURCES if again[name] != after[name]} == {
        "fused_xent", "fused_xent_tc"}
    with open(csrc / "slstm_gates.cuh", "a") as f:
        f.write("\n// edited\n")
    gates = {name: tbuild.library_path(name, csrc) for name in tbuild.SOURCES}
    assert {name for name in tbuild.SOURCES if gates[name] != again[name]} == {
        "slstm_scan", "slstm_scan_persistent", "slstm_scan_bwd", "slstm_scan_bwd_persistent"}
    with open(csrc / "grid_sync.cuh", "a") as f:
        f.write("\n// edited\n")
    synced = {name: tbuild.library_path(name, csrc) for name in tbuild.SOURCES}
    assert {name for name in tbuild.SOURCES if synced[name] != gates[name]} == {
        "quant_exchange", "slstm_scan_persistent", "slstm_scan_bwd_persistent"}
    with open(csrc / "persistent_scan.cuh", "a") as f:
        f.write("\n// edited\n")
    shared = {name: tbuild.library_path(name, csrc) for name in tbuild.SOURCES}
    assert {name for name in tbuild.SOURCES if shared[name] != synced[name]} == {
        "slstm_scan_persistent", "slstm_scan_bwd_persistent"}
    with open(csrc / "flash_attention.cu", "a") as f:
        f.write("\n// edited\n")
    assert tbuild.library_path("flash_attention", csrc) != before["flash_attention"]


# ---------------------------------------------------------------------------
# B2's row and tile layouts
# ---------------------------------------------------------------------------

def _row_cols(d, aligned):
    """The columns of a row that B2's row kernel loads (the kernel's
    row_col), over the row's warps, lanes and values a lane."""
    warps, vals, vec = tqx.row_layout(d, aligned)
    wr, lane, i = np.meshgrid(np.arange(warps), np.arange(32), np.arange(vals), indexing="ij")
    if vec:
        return (((i // 4 * warps + wr) * 32 + lane) * 4 + i % 4).ravel()
    return ((i * warps + wr) * 32 + lane).ravel()


ROW_CASES = [(d, aligned) for d in (1, 31, 32, 200, 256, 260, 1000, 1001, 1024, 1025, 4096,
                                    8191, 8192) for aligned in (True, False)]


@pytest.mark.parametrize("d,aligned", ROW_CASES)
def test_row_layout_covers_every_column_once(d, aligned):
    warps, vals, vec = tqx.row_layout(d, aligned)
    cols = _row_cols(d, aligned)
    np.testing.assert_array_equal(np.sort(cols[cols < d]), np.arange(d))
    assert vec == (aligned and d % 4 == 0 and d > 256)   # one column a lane up to 256
    assert warps in (1, 2, 4, 8) and (tqx.ROW_THREADS // 32) % warps == 0  # whole rows a block
    if d <= tqx.ROW_THREADS:                          # one value a lane, the fewest warps
        assert vals == 1 and (warps == 1 or warps // 2 * 32 < d)
    else:                                             # the block's 8 warps, the rest masked
        assert (warps, vals) == (tqx.ROW_THREADS // 32, tqx.ROW_VALS)


def test_row_layout_refuses_what_the_wide_kernel_takes():
    with pytest.raises(ValueError, match="8192"):
        tqx.row_layout(tqx.MAX_STATS_D + 1, True)


def _tile_cols(vec):
    """A tile's columns as the wide kernel's threads hold them (row_col over
    the block's 32 warps)."""
    threads = tqx.TILE_WARPS * 32
    tid, i = np.meshgrid(np.arange(threads), np.arange(tqx.TILE_COLS // threads),
                         indexing="ij")
    return (((i // 4) * tqx.TILE_WARPS * 32 + tid) * 4 + i % 4 if vec
            else i * tqx.TILE_WARPS * 32 + tid).ravel()


@pytest.mark.parametrize("n,d,sms", [(4, 2_097_152, 132), (3, 20001, 132), (8, 8193, 132),
                                     (1024, 16384, 132), (5, 100_000, 7), (1, 8193, 114)])
def test_wide_layout_covers_every_tile_once(n, d, sms):
    tpr, tiles, per, blocks = tqx.wide_layout(n, d, sms)
    assert tiles == n * tpr and (tpr - 1) * tqx.TILE_COLS < d <= tpr * tqx.TILE_COLS
    assert blocks <= sms and (blocks - 1) * per < tiles <= blocks * per
    for vec in (True, False):
        np.testing.assert_array_equal(np.sort(_tile_cols(vec)), np.arange(tqx.TILE_COLS))


def test_wide_layout_of_the_lm_message():
    """(4, 2,097,152) on an H100: 1,024 tiles over 128 blocks of 8, each
    keeping 7 in shared memory (29 MB of the 33.5 MB)."""
    tpr, tiles, per, blocks = tqx.wide_layout(4, 2_097_152, 132)
    assert (tpr, tiles, per, blocks) == (256, 1024, 8, 128)
    kept = blocks * min(per, tqx.KEPT_TILES) * tqx.TILE_COLS * 4
    assert kept == 7 * 128 * 32768


def _b2_emulation(x, fmt, sms=132):
    """B2 as its kernels compute it, in f32 numpy: each row's |x| max from
    the per-lane maxima of the layout (row kernel up to 8,192 columns; else
    the wide kernel's per-(tile, warp) partial maxima), then the plain
    version's quantize and scale."""
    n, d = x.shape
    vec = d % 4 == 0
    if d <= tqx.MAX_STATS_D:
        cols = _row_cols(d, True)
        live = cols < d
        amax = np.abs(np.where(live, x[:, np.minimum(cols, d - 1)], 0)).max(axis=1)
    else:
        tpr, tiles, _, _ = tqx.wide_layout(n, d, sms)
        tcols = _tile_cols(vec).reshape(tqx.TILE_WARPS, -1)       # a warp's columns
        pmax = np.zeros((tiles, tqx.TILE_WARPS), np.float32)
        for j in range(tiles):
            c = (j % tpr) * tqx.TILE_COLS + tcols
            pmax[j] = np.abs(np.where(c < d, x[j // tpr, np.minimum(c, d - 1)], 0)).max(axis=1)
        amax = pmax.reshape(n, -1).max(axis=1)
    scale = np.maximum(amax, np.float32(1e-12)) * np.float32(tqx.QINV[fmt])
    deq, _ = tqx.quant_dequant_plain(torch.from_numpy(x), fmt)
    return deq.numpy(), scale.astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", [(37, 200), (5, 1001), (3, 8192), (3, 20001), (4, 12288)],
                         ids=lambda s: "x".join(map(str, s)))
def test_b2_layout_emulation_matches_the_pallas_kernel(shape, fmt):
    """Each row's largest |x| sits in a random column: the layouts' maxima
    find it, so deq and scales are the Pallas kernel's bits."""
    x = _wide_message(shape, seed=shape[-1])
    rng = np.random.default_rng(shape[0])
    x[np.arange(shape[0]), rng.integers(0, shape[1], shape[0])] = 50.0 + rng.random(shape[0])
    deq, scale = _b2_emulation(x, fmt)
    jd, js = jops.quant_roundtrip(jnp.asarray(x), fmt, interpret=True)
    np.testing.assert_array_equal(scale, np.asarray(js))
    np.testing.assert_array_equal(deq, np.asarray(jd))
