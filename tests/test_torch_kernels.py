"""Parity of the port's kernels (their plain PyTorch versions, which a CPU
tensor takes) with the JAX Pallas kernels in interpret mode, and the port's
import isolation.

Quant wire: deq and scales must be bit-equal; the fused message stats agree
to a relative 2e-6, the f32 summation-order difference between the two.
Tamper check: the sums and distances agree at rtol 1e-6 (f32 sums of at
most 1e5 terms in two orders), the verdicts exactly, identical finite inputs
give exactly 0 and an inf or a NaN a NaN numerator; the kernel's grid
layout (``tamper_layout``) covers every element exactly once."""
import ast
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.core.split import message_stats as jax_message_stats
from repro.kernels import ops as jops
from repro.kernels.ref import tamper_sums_reference
from repro.kernels.tamper_check import tamper_check_sums as jax_tamper_check_sums
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_exchange as tqx
from repro_torch.kernels import tamper_check as ttc

FORMATS = ("int8", "fp8_e4m3")
STATS_RTOL = 2e-6
CASES = ("16x32", "64x256", "37x200", "1x8", "zero_row", "big_row")


def _message(case: str) -> np.ndarray:
    rng = np.random.default_rng(CASES.index(case))
    shapes = {"16x32": (16, 32), "64x256": (64, 256), "37x200": (37, 200),
              "1x8": (1, 8), "zero_row": (16, 32), "big_row": (16, 32)}
    n, d = shapes[case]
    x = rng.normal(size=(n, d)) * rng.uniform(0.01, 10.0, size=(n, 1))
    if case == "zero_row":
        x[3] = 0.0                                # the eps path of the scale
    if case == "big_row":
        x[5] = rng.normal(size=d) * 1e4
    return x.astype(np.float32)


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


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_quant_roundtrip_bit_equal(case, fmt):
    x = _message(case)
    jd, js = jops.quant_roundtrip(jnp.asarray(x), fmt)
    td, ts = tops.quant_roundtrip(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_quant_roundtrip_stats(case, fmt):
    x = _message(case)
    jd, js, jst = jops.quant_roundtrip_stats(jnp.asarray(x), fmt)
    td, ts, tst = tops.quant_roundtrip_stats(torch.from_numpy(x), fmt)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("case", ("64x256", "37x200"))
def test_message_stats_matches_reference(case):
    """The unquantized path's stats (jnp.linalg.norm against
    torch.linalg.vector_norm: two f32 summation orders over unrounded
    values, so a looser 1e-5)."""
    x = np.maximum(_message(case), 0.0) - 0.1     # mostly ReLU-like support
    np.testing.assert_allclose(
        tqx.message_stats(torch.from_numpy(x)).numpy(),
        np.asarray(jax_message_stats(jnp.asarray(x))), rtol=1e-5, atol=0)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("r,b,d", [(5, 64, 256), (4, 16, 32)])
def test_quant_roundtrip_stats_batched(r, b, d, fmt):
    """R messages in one call: each slot bit-equal to the one-message plain
    version (so deq/scales bit-equal to the Pallas kernel), stats as one
    message's."""
    rng = np.random.default_rng(r * 1000 + d)
    x = (rng.normal(size=(r, b, d)) * rng.uniform(0.01, 10.0, size=(r, b, 1))
         ).astype(np.float32)
    x[1, 2] = 0.0
    td, ts, tst = tops.quant_roundtrip_stats(torch.from_numpy(x), fmt)
    assert td.shape == (r, b, d) and ts.shape == (r, b) and tst.shape == (r, 2)
    for i in range(r):
        od, os_, ost = tqx.quant_dequant_stats_plain(torch.from_numpy(x[i]), fmt)
        assert torch.equal(td[i], od) and torch.equal(ts[i], os_)
        assert torch.equal(tst[i], ost)
        jd, js, jst = jops.quant_roundtrip_stats(jnp.asarray(x[i]), fmt)
        np.testing.assert_array_equal(td[i].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js))
        np.testing.assert_allclose(tst[i].numpy(), np.asarray(jst),
                                   rtol=STATS_RTOL, atol=0)


TAMPER_CASES = ("64x32", "60x32", "3000x32", "tampered", "batch4")


def _activations(case: str):
    """(ref, recv) with a leading candidate axis: cut-layer-like ReLU
    activations; recv equals ref except where the case tampers."""
    rng = np.random.default_rng(TAMPER_CASES.index(case))
    r, n, d = {"64x32": (1, 64, 32), "60x32": (1, 60, 32),
               "3000x32": (1, 3000, 32), "tampered": (3, 64, 32),
               "batch4": (4, 96, 32)}[case]
    ref = np.maximum(rng.normal(size=(r, n, d)), 0.0).astype(np.float32)
    recv = ref.copy()
    if case == "tampered":
        recv[1] += (1e-3 * rng.normal(size=(n, d))).astype(np.float32)
    if case == "batch4":
        recv += (rng.normal(size=(r, n, d)) * np.array([0, 1e-6, 1e-3, 1.0])[:, None, None]
                 ).astype(np.float32)
    return ref, recv


@pytest.mark.parametrize("case", TAMPER_CASES)
def test_tamper_sums_and_distance_match_reference(case):
    ref, recv = _activations(case)
    sums = ttc.tamper_check_sums_plain(torch.from_numpy(ref), torch.from_numpy(recv))
    want = np.stack([np.asarray(tamper_sums_reference(jnp.asarray(a), jnp.asarray(b)))
                     for a, b in zip(ref, recv)])
    np.testing.assert_allclose(sums.numpy(), want, rtol=1e-6, atol=0)
    jdist = np.asarray(jax.vmap(lambda a, b: jops.tamper_distance(a, b, interpret=True))(
        jnp.asarray(ref), jnp.asarray(recv)))
    for dist in (tops.tamper_distance(torch.from_numpy(ref), torch.from_numpy(recv)),
                 ttc.tamper_distance_plain(torch.from_numpy(ref), torch.from_numpy(recv))):
        np.testing.assert_allclose(dist.numpy(), jdist, rtol=1e-6, atol=0)
    # the verify stage's verdicts: the reference's dists <= f32(tol)
    passed, dist = tops.tamper_verdict(torch.from_numpy(ref), torch.from_numpy(recv), 1e-4)
    assert passed.dtype == torch.bool
    np.testing.assert_array_equal(passed.numpy(), jdist <= np.float32(1e-4))
    np.testing.assert_allclose(dist.numpy(), jdist, rtol=1e-6, atol=0)
    # the (N, D) form of one candidate gives the same sums and distance
    one = ttc.tamper_check_sums_plain(torch.from_numpy(ref[0]), torch.from_numpy(recv[0]))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-6, atol=0)
    if case == "tampered":
        assert dist[1] > 1e-4 and dist[0] == 0.0 and dist[2] == 0.0
        assert passed.tolist() == [True, False, True]


def test_tamper_aliased_inf_and_nan_give_a_nan_numerator():
    """ref is recv (the fused round's aliased call): where a candidate holds
    an inf or a NaN, x - x is NaN, so the numerator and the distance are
    NaN and the candidate fails, as in the Pallas kernel; the others give
    exactly 0."""
    ref, _ = _activations("batch4")
    ref[1, 3, 4], ref[2, 0, 0] = np.inf, np.nan
    t = torch.from_numpy(ref)
    sums = ttc.tamper_check_sums_plain(t, t)
    jsums = np.stack([np.asarray(jax_tamper_check_sums(jnp.asarray(a), jnp.asarray(a),
                                                       block_n=32, interpret=True))
                      for a in ref])
    assert np.isnan(jsums[1:3, 0]).all() and (jsums[[0, 3], 0] == 0).all()
    np.testing.assert_array_equal(np.isnan(sums[:, 0].numpy()), np.isnan(jsums[:, 0]))
    np.testing.assert_allclose(sums.numpy(), jsums, rtol=1e-6, atol=0)
    jdist = np.asarray(jax.vmap(lambda a: jops.tamper_distance(a, a, interpret=True))(
        jnp.asarray(ref)))
    passed, dist = tops.tamper_verdict(t, t, 1e-4)
    np.testing.assert_array_equal(np.isnan(dist.numpy()), np.isnan(jdist))
    assert passed.tolist() == [True, False, False, True]
    assert torch.equal(ttc.distance_from_sums(sums)[[0, 3]], torch.zeros(2))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cover(n_elem: int, p: int, chunk: int, aligned: bool, vec: int = 4) -> np.ndarray:
    """How often csrc/tamper_check.cu's blocks of one candidate read each
    element: block b takes [b * chunk, min((b + 1) * chunk, n)); where its
    start is 16-byte aligned, thread t reads vector i = t + T (u + U k)
    (u < U) of its whole vectors of ``vec`` elements (4 f32, 8 bf16), then
    every thread the scalar tail from t in steps of T."""
    t_, u_ = ttc.TAMPER_THREADS, ttc.TAMPER_UNROLL
    counts = np.zeros(n_elem, dtype=np.int64)
    for b in range(p):
        start, end = b * chunk, min((b + 1) * chunk, n_elem)
        tail = start
        if aligned:
            nvec = (end - start) // vec
            k = np.arange(-(-nvec // (t_ * u_)))
            i = (np.arange(t_)[:, None, None]
                 + t_ * (np.arange(u_)[None, :, None] + u_ * k[None, None, :])).ravel()
            i = i[i < nvec]
            np.add.at(counts, (start + vec * i[:, None] + np.arange(vec)).ravel(), 1)
            tail = start + vec * nvec
        np.add.at(counts, np.arange(tail, end), 1)
    return counts


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("shape", _chip_smoke().TAMPER_SHAPES + ((3, 7, 5), (7, 1001, 3),
                                                                (13, 64, 256), (1, 3, 1)),
                         ids=lambda s: "x".join(map(str, s)))
def test_tamper_layout_covers_every_element_once(shape, sms):
    """``tamper_layout`` (the launcher's Python copy of the grid sizing):
    chunks of a multiple of 4 elements that P chunks just cover; every SM
    the same number of blocks (P * R a multiple of the SM count, at least
    TAMPER_BLOCKS_PER_SM an SM) unless an input is too small to spread; and
    the kernel's loops read each element once, with aligned bases and
    without."""
    r, n_elem = shape[0], int(np.prod(shape[1:]))
    p, chunk = ttc.tamper_layout(r, n_elem, sms)
    assert chunk % 4 == 0 and chunk >= ttc.TAMPER_MIN_CHUNK
    assert p * chunk >= n_elem > (p - 1) * chunk
    if chunk > ttc.TAMPER_MIN_CHUNK:
        assert (p * r) % sms == 0 and p * r >= ttc.TAMPER_BLOCKS_PER_SM * sms
    if n_elem <= 1 << 20:
        for aligned in (True, False):
            assert (_cover(n_elem, p, chunk, aligned) == 1).all(), aligned


@pytest.mark.parametrize("sms", [132, 78])
@pytest.mark.parametrize("shape", ((2, 8, 512, 4096), (5, 3000, 256), (3, 37, 201),
                                   (1, 3, 1), (2, 1001, 7)),
                         ids=lambda s: "x".join(map(str, s)))
def test_tamper_layout_covers_every_bf16_element_once(shape, sms):
    """The bf16 route's layout: chunks of a multiple of 8 elements (one
    16-byte load of 8 bf16), so every aligned block start stays 16-byte
    aligned; each element read once (the LM round's (2, 8, 512, 4,096)
    activations and edges whose element count is not a multiple of 8)."""
    r, n_elem = shape[0], int(np.prod(shape[1:]))
    vec = ttc.TAMPER_VEC[torch.bfloat16]
    p, chunk = ttc.tamper_layout(r, n_elem, sms, vec)
    assert vec == 8 and chunk % vec == 0 and chunk >= ttc.TAMPER_MIN_CHUNK
    assert p * chunk >= n_elem > (p - 1) * chunk
    if chunk > ttc.TAMPER_MIN_CHUNK:
        assert (p * r) % sms == 0 and p * r >= ttc.TAMPER_BLOCKS_PER_SM * sms
    if n_elem <= 1 << 24:
        for aligned in (True, False):
            assert (_cover(n_elem, p, chunk, aligned, vec) == 1).all(), aligned
    assert ttc.tamper_layout(r, n_elem, sms) == ttc.tamper_layout(
        r, n_elem, sms, ttc.TAMPER_VEC[torch.float32])


def test_tamper_layout_at_the_cifar_round():
    """(5, 3000, 256) on 132 SMs: 132 chunks of 5,820 elements a candidate,
    660 blocks, 5 an SM."""
    assert ttc.tamper_layout(5, 3000 * 256, 132) == (132, 5820)


def test_tamper_constants_equal_the_source():
    text = (tbuild.CSRC / "tamper_check.cu").read_text()
    for const, value in (("kThreads", ttc.TAMPER_THREADS), ("kUnroll", ttc.TAMPER_UNROLL)):
        assert re.findall(rf"constexpr int {const} = (\d+);", text) == [str(value)], const
    assert "kMinChunk = static_cast<int64_t>(kThreads) * 4 * kUnroll;" in text
    assert ttc._CONSTANTS == {"kThreads": ttc.TAMPER_THREADS, "kUnroll": ttc.TAMPER_UNROLL,
                              "kMinChunk": ttc.TAMPER_THREADS * 4 * ttc.TAMPER_UNROLL}


def test_tamper_distance_identical_is_exactly_zero():
    ref, _ = _activations("batch4")
    ref[2, 5, 7] = 3e38                    # large values square to inf in den only
    t = torch.from_numpy(ref)
    assert torch.equal(ttc.tamper_check_sums_plain(t, t)[:, 0], torch.zeros(4))
    assert torch.equal(tops.tamper_distance(t, t), torch.zeros(4))
    assert torch.equal(ttc.tamper_distance_plain(t, t), torch.zeros(4))
    assert float(tops.tamper_distance(t[0], t[0])) == 0.0


def test_tamper_launcher_refuses_cpu_tensors_and_bad_shapes():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tamper_check_sums(x, x)
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tamper_check(x, x, 1e-4)
    with pytest.raises(ValueError, match="differ"):
        ttc.tamper_check_sums_plain(x, x[:1])


def test_launchers_refuse_cpu_tensors_and_bad_formats():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tqx.quant_dequant(x, "int8")
    with pytest.raises(ValueError, match="CUDA"):
        tqx.quant_dequant_stats(x, "fp8_e4m3")
    with pytest.raises(ValueError, match="quant format"):
        tops.quant_roundtrip(x, "int4")


REPO = Path(__file__).resolve().parents[1]


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_import_anywhere_in_the_port():
    """Every import statement of the port and of chip_smoke.py, those inside
    functions too."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_imports_no_jax_and_no_reference():
    """Every repro_torch module imports without pulling in jax or the
    reference package (repro_torch itself starts with "repro", so names are
    matched exactly)."""
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n.startswith("jaxlib")
             or n == "repro" or n.startswith("repro."))
assert not bad, bad
print(len([n for n in sys.modules if n.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
