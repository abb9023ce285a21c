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
    """Editing a header (sm90.cuh, xent_combine.cuh) renames the libraries
    of the sources that include it (the four tensor-core sources include
    sm90.cuh), and only theirs; nothing is compiled."""
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
    with open(csrc / "flash_attention.cu", "a") as f:
        f.write("\n// edited\n")
    assert tbuild.library_path("flash_attention", csrc) != before["flash_attention"]
