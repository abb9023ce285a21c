"""B6's partial mode on the CPU: the plain ``decode_attention_partial`` over
G panels of a cache, merged by ``combine_partials``, against the
reference's ``decode_attention`` Pallas kernel (interpret mode) and its
``ref.py`` oracle over the whole cache.

The cache (B 2, S 256, Hkv 2) is cut into G in {1, 2, 4, 16} panels of
S / G positions, each with its absolute base; the token's ``index`` lies in
the first, a middle and the last panel; head dims 64, 80, 128 and 256, GQA
ratios 1 and 4, no window and a window of 8 (smaller than every panel).
Tolerances: atol 2e-5 in f32 and 2e-2 in bf16, as
``tests/test_torch_attention.py`` holds B6's one-call plain version.  A
panel with no live key must give out 0 and lse -inf exactly, and no NaN
may appear anywhere.  The CUDA kernels' partial mode runs only on the card
(``chip_smoke.py`` phase 1 holds both routes against this plain version);
here a CPU tensor never reaches a kernel."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import ops as tops
from repro_torch.launch import op_analysis, roofline
from _torch_threads import one_thread  # noqa: F401

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
B, S, HKV = 2, 256, 2
SPLITS = (1, 2, 4, 16)
INDICES = (5, 130, 250)          # the first panel, a middle one, the last one at G 16
WINDOW = 8                       # smaller than the smallest panel (S / 16 = 16)


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


def _qkv(seed, h, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, d)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, d)).astype(np.float32)
    return q, k, v


def _heads_first(x):
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _heads_last(x, b):
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


def _references(q, k, v, index, window):
    """The Pallas kernel (interpret mode) and the oracle over the whole cache."""
    pallas = jops.decode_attention(*(jnp.asarray(x) for x in (q, k, v)), index, window=window,
                                   block_k=128, interpret=True)
    oracle = ref.decode_attention_reference(*(jnp.asarray(_heads_first(x)) for x in (q, k, v)),
                                            index, window=window)
    return [np.asarray(pallas, np.float32), _heads_last(np.asarray(oracle, np.float32), B)]


def _partials(q, k, v, index, window, g, dtype=torch.float32):
    """Each of G panels' (out, lse) through ``ops.decode_attention_partial``."""
    length = S // g
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    return [tops.decode_attention_partial(tq, tk[:, p * length:(p + 1) * length],
                                          tv[:, p * length:(p + 1) * length], index,
                                          base=p * length, window=window)
            for p in range(g)]


def _check_empty_panels(parts, index, window, g):
    """A panel with no live key: lse -inf and out 0 exactly; none NaN."""
    length = S // g
    empties = 0
    for p, (out, lse) in enumerate(parts):
        assert out.dtype == torch.float32 and lse.dtype == torch.float32
        assert out.shape == (B, 1, out.shape[2], out.shape[3]) and lse.shape == out.shape[:3]
        assert not torch.isnan(out).any() and not torch.isnan(lse).any()
        live = tda.panel_keys(index, p * length, length, window)
        if live == 0:
            empties += 1
            assert torch.isneginf(lse).all() and torch.equal(out, torch.zeros_like(out)), p
        else:
            assert torch.isfinite(lse).all(), p
    return empties


@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_combined_partials_match_pallas_and_oracle(d, group, window):
    q, k, v = _qkv(d + group + window, HKV * group, d)
    for index in INDICES:
        wants = _references(q, k, v, index, window)
        for g in SPLITS:
            parts = _partials(q, k, v, index, window, g)
            empties = _check_empty_panels(parts, index, window, g)
            if index == INDICES[0]:
                assert empties == g - 1             # every panel past the first
            got = tda.combine_partials(torch.stack([o for o, _ in parts]),
                                       torch.stack([lse for _, lse in parts]))
            assert got.shape == (B, 1, HKV * group, d) and not torch.isnan(got).any()
            for want in wants:
                np.testing.assert_allclose(got.numpy(), want, atol=ATOL["float32"],
                                           err_msg=f"index {index} G {g}")


def test_bf16_partials_match_pallas():
    """bf16 q and cache (the serve path's dtype): the combined panels, cast
    to q's dtype, within the bf16 tolerance of the Pallas kernel's bf16
    output and the one-call plain version's."""
    q, k, v = _qkv(7, 8, 128)
    bf = jnp.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(bf) for x in (q, k, v))
    for index in INDICES:
        want = np.asarray(jops.decode_attention(jq, jk, jv, index, block_k=128,
                                                interpret=True), np.float32)
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
        one = tda.decode_attention_plain(tq, tk, tv, index)
        for g in SPLITS:
            parts = _partials(q, k, v, index, 0, g, torch.bfloat16)
            got = tda.combine_partials(torch.stack([o for o, _ in parts]),
                                       torch.stack([lse for _, lse in parts]), torch.bfloat16)
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL["bfloat16"])
            np.testing.assert_allclose(got.float().numpy(), one.float().numpy(),
                                       atol=ATOL["bfloat16"])


def test_one_live_panel_combines_exactly():
    """Every panel but one empty: the combine returns that panel's out bit
    for bit (weights exp(0) = 1 and exp(-inf) = 0)."""
    q, k, v = _qkv(3, 4, 64)
    parts = _partials(q, k, v, 20, WINDOW, 4)          # window [13, 20]: panel 0 alone
    assert [bool(torch.isfinite(lse).all()) for _, lse in parts] == [True, False, False, False]
    got = tda.combine_partials(torch.stack([o for o, _ in parts]),
                               torch.stack([lse for _, lse in parts]))
    assert torch.equal(got, parts[0][0])


def test_index_before_inside_and_past_a_panel():
    """The panel [64, 128): an index before it sees nothing, one inside sees
    the keys up to it, one past it every key (or its window's)."""
    q, k, v = _qkv(5, 4, 64)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    panel_k, panel_v = tk[:, 64:128], tv[:, 64:128]
    for index, window, live in ((10, 0, 0), (63, 0, 0), (64, 0, 1), (100, 0, 37), (200, 0, 64),
                                (200, 100, 27), (250, 100, 0)):
        assert tda.panel_keys(index, 64, 64, window) == live
        out, lse = tops.decode_attention_partial(tq, panel_k, panel_v, index, base=64,
                                                 window=window)
        assert bool(torch.isneginf(lse).all()) == (live == 0)
        if live:
            lo = max(64, index - window + 1) if window else 64
            hi = min(index + 1, 128)
            want = ref.decode_attention_reference(
                jnp.asarray(_heads_first(q)), jnp.asarray(_heads_first(k[:, lo:hi])),
                jnp.asarray(_heads_first(v[:, lo:hi])), hi - lo - 1)
            np.testing.assert_allclose(out.numpy(), _heads_last(np.asarray(want), B),
                                       atol=ATOL["float32"])
            scores = np.einsum("bhd,bkhd->bhk", q[:, 0], np.repeat(k[:, lo:hi], 2, axis=2))
            np.testing.assert_allclose(lse[:, 0].numpy(), np.log(np.exp(
                scores / math.sqrt(64)).sum(-1)), rtol=1e-5)


def test_meta_rule_roofline_work_and_the_launcher():
    """The meta rule gives the kernel's output shapes and dtypes; the work
    counts the panel's live keys; the CUDA launcher refuses CPU tensors
    (no fallback to the plain version)."""
    meta = torch.device("meta")
    q = torch.empty(2, 1, 8, 128, dtype=torch.bfloat16, device=meta)
    k = torch.empty(2, 512, 2, 128, dtype=torch.bfloat16, device=meta)
    out, lse = tops.decode_attention_partial(q, k, k, 700, base=512, window=0)
    assert (out.shape, out.dtype, lse.shape, lse.dtype) == (
        (2, 1, 8, 128), torch.float32, (2, 1, 8), torch.float32)
    work = roofline.decode_attention_partial_work(2, 512, 8, 2, 128, 512, 0, 700)
    assert work.ops == 4 * 128 * 189 * 2 * 8
    assert work.bytes == 2 * (2 * 8 * 128 + 2 * 2 * 189 * 2 * 128) + 4 * (2 * 8 * 128 + 2 * 8)
    assert roofline.decode_attention_partial_work(2, 512, 8, 2, 128, 1024, 0, 700).ops == 0
    assert op_analysis.kernel_work("decode_attention_partial", (q, k, k),
                                   dict(index=700, base=512, window=0)) == work
    cpu = torch.zeros(1, 1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention_partial(cpu, torch.zeros(1, 8, 1, 64), torch.zeros(1, 8, 1, 64),
                                     3, base=0)
