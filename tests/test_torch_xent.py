"""Parity of the port's fused cross-entropy (B4) on the CPU: its plain
version, which a CPU tensor takes, against the JAX Pallas kernel in
interpret mode and ``ref.xent_reference``, at the shapes of
``tests/test_kernels.py``; its gradient against ``jax.grad`` of the oracle;
the chunked backward that the CUDA path runs, here with its plain
elementwise pass.

Tolerances: the reference's own, 1e-5 in f32 and 3e-2 in bf16 (the two
frameworks sum the D-long products in different orders); gradients atol
1e-5 in f32.  The CUDA kernels run only on the card (``chip_smoke.py``
phase 1 holds them against these plain versions)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_xent as jfx
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models.blocks import cross_entropy as jax_cross_entropy
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import fused_xent as tfx
from repro_torch.kernels import ops as tops
from _torch_threads import one_thread  # noqa: F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GRAD_ATOL = 1e-5
# (T, D, V, block_t, block_v): tests/test_kernels.py's fused_xent cases
CASES = {"t256_v512": (256, 64, 512, 64, 128), "v1000": (128, 128, 1000, 128, 250),
         "t512_v64": (512, 32, 64, 256, 64)}


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


def _inputs(seed, t, d, v, dtype="float32"):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(t, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.05).astype(np.float32)
    labels = rng.integers(0, v, size=t).astype(np.int32)
    jdt = getattr(jnp, dtype)
    return jnp.asarray(h).astype(jdt), jnp.asarray(w).astype(jdt), labels


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_xent_matches_pallas_and_oracle(case, dtype):
    t, d, v, bt, bv = CASES[case]
    h, w, labels = _inputs(2, t, d, v, dtype)
    per_tok = tfx.fused_xent_plain(_t(h, dtype), _t(w, dtype), torch.from_numpy(labels))
    assert per_tok.dtype == torch.float32 and per_tok.shape == (t,)
    pallas = jfx.fused_xent(h, w, jnp.asarray(labels), block_t=bt, block_v=bv,
                            interpret=True)
    oracle = ref.xent_reference(h, w, jnp.asarray(labels))
    for want in (pallas, oracle):
        np.testing.assert_allclose(per_tok.numpy(), np.asarray(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])
    mean = tops.fused_cross_entropy(_t(h, dtype), _t(w, dtype), torch.from_numpy(labels))
    want = jops.fused_cross_entropy(h, w, jnp.asarray(labels), block_t=bt, block_v=bv,
                                    interpret=True)
    np.testing.assert_allclose(float(mean), float(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_fused_xent_label_edges_and_out_of_range():
    """Labels on vocab panel edges hit once; labels outside [0, V) pick 0,
    as the Pallas kernel's panels never hit them."""
    t, d, v = 64, 32, 256
    h, w, _ = _inputs(3, t, d, v)
    labels = np.array([0, 63, 64, 127, 128, 255] * 8 + [-1, 256, 300, -100] * 4,
                      dtype=np.int32)
    got = tfx.fused_xent_plain(_t(h), _t(w), torch.from_numpy(labels))
    want = jfx.fused_xent(h, w, jnp.asarray(labels), block_t=32, block_v=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL["float32"],
                               rtol=TOL["float32"])
    inside = (labels >= 0) & (labels < v)
    oracle = ref.xent_reference(h, w, jnp.asarray(np.where(inside, labels, 0)))
    np.testing.assert_allclose(got.numpy()[inside], np.asarray(oracle)[inside],
                               atol=TOL["float32"])


def test_masked_mean_matches_reference_cross_entropy():
    """``ops.fused_cross_entropy`` with a mask over (B, S) labels is
    ``blocks.cross_entropy``'s masked mean; an all-zero mask gives 0."""
    b, s, d, v = 3, 10, 16, 40
    rng = np.random.default_rng(4)
    h = rng.normal(size=(b, s, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.1).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.4).astype(np.float32)
    logits = jnp.asarray(h) @ jnp.asarray(w)
    for m in (mask, np.zeros_like(mask)):
        got = tops.fused_cross_entropy(_t(h), _t(w), torch.from_numpy(labels),
                                       torch.from_numpy(m))
        want = jax_cross_entropy(logits, jnp.asarray(labels), jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), atol=TOL["float32"])
    got = tops.fused_cross_entropy(_t(h), _t(w), torch.from_numpy(labels))
    want = jax_cross_entropy(logits, jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), atol=TOL["float32"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_grad_of_the_oracle(case):
    """d/dh and d/dW of sum(g * loss) through the plain version (what a CPU
    tensor trains through) against jax.grad of ``xent_reference``."""
    t, d, v, _, _ = CASES[case]
    h, w, labels = _inputs(5, t, d, v)
    g = np.random.default_rng(6).normal(size=t).astype(np.float32)

    def jloss(h_, w_):
        return jnp.sum(ref.xent_reference(h_, w_, jnp.asarray(labels)) * jnp.asarray(g))

    jdh, jdw = jax.grad(jloss, argnums=(0, 1))(h, w)
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    loss = torch.sum(tfx.fused_xent_plain(th, tw, torch.from_numpy(labels)) * _t(g))
    dh, dw = torch.autograd.grad(loss, (th, tw))
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), atol=GRAD_ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), atol=GRAD_ATOL)


def _xent_grad_plain(logits, lse, labels, g):
    """What the ``xent_grad`` kernel does to one chunk, in place on its f32
    logits: ``(exp(logits - lse) - onehot(label)) * g``; returns 0 (no
    error), as the launcher returns its cudaError_t."""
    logits.sub_(lse[:, None]).exp_()
    inside = (labels >= 0) & (labels < logits.shape[-1])
    rows = torch.nonzero(inside)[:, 0]
    logits[rows, labels[rows].long()] -= 1.0
    logits.mul_(g[:, None])
    return 0


@pytest.mark.parametrize("dtype,rows", [("float32", 7), ("float32", 64), ("bfloat16", 13)])
def test_chunked_backward_matches_autograd_of_the_plain_version(dtype, rows, monkeypatch):
    """The CUDA path's backward (logits per chunk of rows, the elementwise
    pass in place, the two products), its ``xent_grad`` launch replaced by
    the same pass in plain torch, at a chunk that leaves a ragged last
    chunk, against autograd of the plain version; out-of-range labels
    included."""
    t, d, v = 50, 24, 90
    monkeypatch.setattr(tfx, "CHUNK_BYTES", rows * 4 * v)
    monkeypatch.setattr(tfx, "_xent_grad", _xent_grad_plain)
    assert tfx.chunk_rows(v) == rows
    h, w, labels = _inputs(7, t, d, v, dtype)
    labels[:3] = [-1, v, 89]
    g = np.random.default_rng(8).normal(size=t).astype(np.float32)
    th, tw = _t(h, dtype).requires_grad_(), _t(w, dtype).requires_grad_()
    lab = torch.from_numpy(labels)
    loss = torch.sum(tfx.fused_xent_plain(th, tw, lab) * _t(g))
    want_dh, want_dw = torch.autograd.grad(loss, (th, tw))
    with torch.no_grad():
        logits = th.float() @ tw.float()
        lse = torch.logsumexp(logits, dim=-1)
        dh, dw, err = tfx.xent_backward(th, tw, lab, lse, _t(g))
    assert err == 0 and dh.dtype == th.dtype and dw.dtype == tw.dtype
    tol = GRAD_ATOL if dtype == "float32" else TOL[dtype]
    for got, want in ((dh, want_dh), (dw, want_dw)):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=tol,
                                   rtol=0 if dtype == "float32" else tol)


@pytest.mark.parametrize("t,v,sms", [(2048, 151936, 132), (8192, 151936, 132), (1, 7, 132),
                                     (37, 1000, 132), (300, 50257, 16)])
def test_forward_grid_covers_every_panel(t, v, sms):
    per_block, nsplit = tfx.xent_splits(t, v, sms)
    n_panels = -(-v // tfx.PANEL_V)
    assert per_block >= 1 and (nsplit - 1) * per_block < n_panels <= nsplit * per_block
    assert nsplit <= 65535


def test_chunk_rows_hold_half_a_gigabyte():
    assert tfx.chunk_rows(151936) == 883
    assert tfx.chunk_rows(151936) * 151936 * 4 <= tfx.CHUNK_BYTES
    assert tfx.chunk_rows(64) == 65535


def test_launchers_refuse_cpu_tensors_and_gradients():
    h, w = torch.zeros((4, 8)), torch.zeros((8, 16))
    labels = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tfx.fused_xent(h, w, labels)
    with pytest.raises(RuntimeError, match="no backward"):
        tfx.fused_xent(h.requires_grad_(), w, labels)
    with pytest.raises(ValueError, match="CUDA"):
        tfx.fused_xent_bwd(h.detach(), w, labels, torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="disagree"):
        tfx.fused_xent_plain(torch.zeros((4, 8)), torch.zeros((9, 16)), labels)


def test_ops_take_the_plain_version_on_the_cpu():
    h, w, labels = _inputs(9, 12, 8, 30)
    th, tw, lab = _t(h), _t(w), torch.from_numpy(labels)
    got = tops.fused_cross_entropy(th.reshape(3, 4, 8), tw, lab.reshape(3, 4))
    assert torch.equal(got, torch.mean(tfx.fused_xent_plain(th, tw, lab)))
