"""Parity of the port's attention kernels B5 (flash attention, the prefill)
and B6 (decode attention) on the CPU: their plain versions, which a CPU
tensor takes, against the JAX Pallas kernels in interpret mode and the
``ref.py`` oracles, at the sizes of ``tests/test_kernels.py``.

Tolerances: atol 2e-5 in f32 (the two frameworks sum the score and value
products in different orders), 2e-2 in bf16, as the JAX kernel tests hold
their kernels; the plain version's gradients (dq, dk, dv, what a CPU
tensor trains through) atol 1e-5 against ``jax.grad`` of the oracle.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` phase 1 holds them against these plain versions); here
the Python around them is checked: dispatch, argument checks, the decode
split."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from _torch_threads import one_thread  # noqa: F401

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_ATOL = 1e-5
# (B, S, H, Hkv, D, window), tests/test_kernels.py's flash cases
FLASH_CASES = {
    "gqa": (2, 128, 4, 2, 64, 0),
    "d32": (1, 256, 2, 2, 32, 0),
    "mqa": (2, 128, 8, 1, 64, 0),
    "window64": (1, 256, 4, 4, 64, 64),
    "d128_window16": (1, 128, 4, 2, 128, 16),
}
# Sq not a multiple of any block: only the oracle takes them
RAGGED_CASES = {"s37": (2, 37, 4, 2, 64, 0), "s100_window16": (1, 100, 4, 1, 32, 16),
                "s1": (1, 1, 2, 1, 80, 0)}
# (B, S, H, Hkv, D, window, index), tests/test_kernels.py's decode cases
DECODE_CASES = {
    "full": (2, 256, 4, 2, 64, 0, 255),
    "partial_mqa": (1, 512, 4, 1, 64, 0, 100),
    "window": (2, 256, 2, 2, 32, 64, 200),
    "d128": (1, 1024, 8, 2, 128, 0, 1023),
    "index0": (2, 256, 4, 2, 64, 0, 0),
    "index0_window": (1, 128, 2, 1, 32, 16, 0),
}


def _qkv(seed, b, sq, sk, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    return q, k, v


def _heads_first(x):
    """(B, S, H, D) -> (B*H, S, D), the Pallas kernels' and oracles' layout."""
    b, s, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)


def _heads_last(x, b):
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(0, 2, 1, 3)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def _np(x):
    return np.asarray(x.to(torch.float32))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_matches_pallas_and_oracle(case, dtype):
    b, s, h, hkv, d, win = FLASH_CASES[case]
    q, k, v = _qkv(0, b, s, s, h, hkv, d)
    jdt = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    pallas = jops.flash_attention(jq, jk, jv, window=win, block_q=64, block_k=64,
                                  interpret=True)
    oracle = _heads_last(ref.mha_reference(_heads_first(jq), _heads_first(jk),
                                           _heads_first(jv), window=win), b)
    got = tops.flash_attention(_t(jq, dtype), _t(jk, dtype), _t(jv, dtype), window=win)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=ATOL[dtype], rtol=ATOL[dtype])


@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_flash_attention_ragged_matches_oracle(case):
    b, s, h, hkv, d, win = RAGGED_CASES[case]
    q, k, v = _qkv(1, b, s, s, h, hkv, d)
    want = _heads_last(ref.mha_reference(_heads_first(q), _heads_first(k), _heads_first(v),
                                         window=win), b)
    got = tops.flash_attention(_t(q), _t(k), _t(v), window=win)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL["float32"])


def test_flash_attention_fewer_queries_than_keys_matches_oracle():
    """Sq < Sk: query i still sees keys j <= i (positions count from 0 on
    both sides, as in the reference)."""
    q, k, v = _qkv(2, 1, 64, 96, 4, 2, 32)
    want = _heads_last(ref.mha_reference(_heads_first(q), _heads_first(k), _heads_first(v),
                                         window=8), 1)
    got = tops.flash_attention(_t(q), _t(k), _t(v), window=8)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL["float32"])


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_matches_pallas_and_oracle(case):
    b, s, h, hkv, d, win, idx = DECODE_CASES[case]
    q, k, v = _qkv(8, b, 1, s, h, hkv, d)
    oracle = _heads_last(ref.decode_attention_reference(
        _heads_first(q), _heads_first(k), _heads_first(v), idx, window=win), b)
    got = tops.decode_attention(_t(q), _t(k), _t(v), idx, window=win)
    assert got.shape == (b, 1, h, d)
    wants = [oracle]
    if s % 128 == 0:                        # the Pallas kernel's block divisibility
        wants.append(jops.decode_attention(q, k, v, idx, window=win, block_k=128,
                                           interpret=True))
    for want in wants:
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL["float32"])


@pytest.mark.parametrize("case", ["full", "window", "index0_window"])
def test_decode_attention_plain_takes_a_device_scalar_index(case):
    """``index`` as the reference takes it, a 0-d int32 tensor: the plain
    version (what a CPU tensor takes) gives the host int's bits and matches
    the Pallas kernel fed a jnp scalar."""
    b, s, h, hkv, d, win, idx = DECODE_CASES[case]
    q, k, v = _qkv(9, b, 1, s, h, hkv, d)
    index = torch.tensor(idx, dtype=torch.int32)
    got = tops.decode_attention(_t(q), _t(k), _t(v), index, window=win)
    assert torch.equal(got, tops.decode_attention(_t(q), _t(k), _t(v), idx, window=win))
    want = jops.decode_attention(q, k, v, jnp.int32(idx), window=win, block_k=128,
                                 interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL["float32"])


@pytest.mark.parametrize("win", [0, 5])
def test_decode_attention_is_flash_attention_at_the_index_row(win):
    """A decode step at ``index`` computes row ``index`` of the prefill's
    attention over the first index + 1 keys; the stale cache after it does
    not count."""
    q, k, v = _qkv(3, 2, 24, 24, 4, 2, 32)
    full = tops.flash_attention(_t(q), _t(k), _t(v), window=win)
    for idx in (0, 7, 23):
        stale_k, stale_v = k.copy(), v.copy()
        stale_k[:, idx + 1:] = 1e3                 # stale positions must not count
        stale_v[:, idx + 1:] = -1e3
        row = tops.decode_attention(_t(q[:, idx:idx + 1]), _t(stale_k), _t(stale_v), idx,
                                    window=win)
        np.testing.assert_allclose(_np(row), _np(full[:, idx:idx + 1]), atol=1e-6)


@pytest.mark.parametrize("n_keys,blocks", [(1, 32), (64, 32), (480, 32), (512, 32),
                                           (32768, 64), (100, 1), (5000, 528)])
def test_decode_splits_cover_the_live_range(n_keys, blocks):
    chunk, splits = tda.decode_splits(n_keys, blocks, sms=132)
    assert chunk % 32 == 0 and chunk >= tda.MIN_CHUNK
    assert (splits - 1) * chunk < n_keys <= splits * chunk
    assert tda.decode_splits(n_keys, blocks, sms=132) == (chunk, splits)


def test_live_range():
    assert tda.live_range(0, 0) == (0, 1)
    assert tda.live_range(479, 0) == (0, 480)
    assert tda.live_range(479, 16) == (464, 480)
    assert tda.live_range(3, 16) == (0, 4)


def test_launchers_refuse_cpu_tensors_gradients_and_bad_shapes():
    q = torch.zeros((1, 8, 4, 64))
    kv = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(q[:, :1], kv, kv, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(), kv, kv)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tfa.flash_attention_plain(torch.zeros((1, 8, 3, 64)), kv, kv)
    with pytest.raises(ValueError, match="B, Sk, Hkv, D"):
        tda.decode_attention_plain(q[:, :1], kv, kv[:, :4], 3)


def test_ops_take_the_plain_versions_on_the_cpu():
    q, k, v = (_t(x) for x in _qkv(4, 2, 16, 16, 4, 2, 32))
    assert torch.equal(tops.flash_attention(q, k, v, window=4),
                       tfa.flash_attention_plain(q, k, v, window=4))
    assert torch.equal(tops.decode_attention(q[:, 5:6], k, v, 5),
                       tda.decode_attention_plain(q[:, 5:6], k, v, 5))


# (B, Sq, Sk, H, Hkv, D, window): GQA groups 1/2/4, MQA, windows, ragged S,
# fewer queries than keys
GRAD_CASES = {
    "gqa": (2, 32, 32, 4, 2, 64, 0),
    "groups1_window8": (1, 40, 40, 2, 2, 32, 8),
    "mqa": (2, 24, 24, 4, 1, 32, 0),
    "group4_ragged": (1, 37, 37, 8, 2, 80, 0),
    "sq_lt_sk_window5": (1, 20, 30, 4, 2, 32, 5),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_attention_gradients_match_jax_grad_of_the_oracle(case):
    b, sq, sk, h, hkv, d, win = GRAD_CASES[case]
    q, k, v = _qkv(10, b, sq, sk, h, hkv, d)
    g = np.random.default_rng(11).normal(size=(b, sq, h, d)).astype(np.float32)

    def jloss(q_, k_, v_):
        out = _heads_last(ref.mha_reference(_heads_first(q_), _heads_first(k_),
                                            _heads_first(v_), window=win), b)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    loss = torch.sum(tops.flash_attention(tq, tk, tv, window=win) * _t(g))
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=name)


def test_backward_launcher_refuses_cpu_tensors():
    q = torch.zeros((1, 8, 4, 64))
    kv = torch.zeros((1, 8, 2, 64))
    lse = torch.zeros((1, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, kv, kv, q, q, lse)
