"""Parity of the port's kernels (their plain PyTorch versions, which a CPU
tensor takes) with the JAX Pallas kernels in interpret mode, and the port's
import isolation.

Quant wire: deq and scales must be bit-equal; the fused message stats agree
to a relative 2e-6, the f32 summation-order difference between the two.
Tamper check: the sums agree at rtol 1e-6 (f32 sums of at most 1e5 terms in
two orders), and identical inputs give exactly 0."""
import ast
import os
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
    dist = tops.tamper_distance(torch.from_numpy(ref), torch.from_numpy(recv))
    jdist = jax.vmap(lambda a, b: jops.tamper_distance(a, b, interpret=True))(
        jnp.asarray(ref), jnp.asarray(recv))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6, atol=0)
    # the (N, D) form of one candidate gives the same sums and distance
    one = ttc.tamper_check_sums_plain(torch.from_numpy(ref[0]), torch.from_numpy(recv[0]))
    np.testing.assert_allclose(one.numpy(), want[0], rtol=1e-6, atol=0)
    if case == "tampered":
        assert dist[1] > 1e-4 and dist[0] == 0.0 and dist[2] == 0.0


def test_tamper_distance_identical_is_exactly_zero():
    ref, _ = _activations("batch4")
    ref[2, 5, 7] = 3e38                    # large values square to inf in den only
    t = torch.from_numpy(ref)
    assert torch.equal(ttc.tamper_check_sums_plain(t, t)[:, 0], torch.zeros(4))
    assert torch.equal(tops.tamper_distance(t, t), torch.zeros(4))
    assert float(tops.tamper_distance(t[0], t[0])) == 0.0


def test_tamper_launcher_refuses_cpu_tensors_and_bad_shapes():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ttc.tamper_check_sums(x, x)
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
