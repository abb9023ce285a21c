"""Parity of the port's quant kernels (their plain PyTorch versions, which a
CPU tensor takes) with the JAX Pallas kernels in interpret mode, and the
port's import isolation.

deq and scales must be bit-equal; the fused message stats agree to a
relative 2e-6, the f32 summation-order difference between the two."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.split import message_stats as jax_message_stats
from repro.kernels import ops as jops
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_exchange as tqx

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
    tqx.reset_launches()
    yield
    assert tqx.LAUNCHES == {"quant_dequant": 0, "quant_dequant_stats": 0}


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
