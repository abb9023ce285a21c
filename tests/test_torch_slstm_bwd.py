"""B7's backward on the CPU: the reverse-time scan the kernels
(``csrc/slstm_scan_bwd_persistent.cu`` and the step route
``csrc/slstm_scan_bwd.cu``) compute, as their plain version
``slstm_scan_bwd_plain``, ``SlstmScan``'s wiring (the saving forward, the
reverse scan, the dR product and the casts) run with the plain callees, and
the launcher's refusals on both routes.

Tolerances: dpre and dR within atol 1e-5 of torch autograd of
``slstm_scan_plain`` and of ``jax.grad`` of ``ref.slstm_scan_reference``
(f32; the reverse scan sums its products, and dR its rows, in another order
than either autograd).  With bf16 pre and r, dpre equals the f32 reverse
scan's dz rounded once to bf16, bit for bit, and dR lies within one bf16
ulp of the f32 dR (a single rounding).  The kernel itself runs only on the
card (``chip_smoke.py`` phase 1 holds it against autograd of the plain
version)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slstm_scan as tss
from _torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
# (T, B, d, H): tests/test_torch_xlstm.py's scan shapes (H 1, 2, 4; dh 40;
# one step)
SCAN_SHAPES = [(16, 2, 32, 2), (32, 1, 64, 4), (8, 4, 16, 1), (9, 3, 80, 2), (1, 1, 8, 1)]


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _inputs(t, b, d, h, seed=0):
    """pre ~ N(0, 1), r ~ N(0, 1) / sqrt(dh) (the model's init) and the
    output gradient's weights, all f32 numpy."""
    rng = np.random.default_rng(seed)
    dh = d // h
    pre = rng.normal(size=(t, b, 4 * d)).astype(np.float32)
    r = (rng.normal(size=(h, dh, 4 * dh)) / np.sqrt(dh)).astype(np.float32)
    w = rng.normal(size=(t, b, d)).astype(np.float32)
    return pre, r, w


def _autograd(pre, r, w, h):
    tp, tr = (torch.from_numpy(a).requires_grad_() for a in (pre, r))
    out = tss.slstm_scan_plain(tp, tr, h)
    return torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tp, tr))


def _reverse_scan(pre, r, w, h):
    """dpre and dR from the saving forward, the plain reverse scan and the
    dR product, without autograd."""
    tp, tr = torch.from_numpy(pre), torch.from_numpy(r)
    _, z, state = tss.slstm_scan_saving_plain(tp, tr, h)
    dz = tss.slstm_scan_bwd_plain(torch.from_numpy(w), tr, z, state, h)
    return dz, tss.recurrent_weight_grad(state[0], dz, h)


def _jax_grad(pre, r, w, h):
    def loss(p, rr):
        return jnp.sum(ref.slstm_scan_reference(p, rr, n_heads=h) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(pre),
                                                                  jnp.asarray(r))]


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reverse_scan_matches_autograd(shape):
    pre, r, w = _inputs(*shape)
    dpre, dr = _reverse_scan(pre, r, w, shape[3])
    want = _autograd(pre, r, w, shape[3])
    assert dpre.dtype == dr.dtype == torch.float32
    assert dpre.shape == pre.shape and dr.shape == r.shape
    for got, exp in zip((dpre, dr), want):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reverse_scan_matches_jax_grad(shape):
    pre, r, w = _inputs(*shape, seed=1)
    got = _reverse_scan(pre, r, w, shape[3])
    for g, exp in zip(got, _jax_grad(pre, r, w, shape[3])):
        np.testing.assert_allclose(g.numpy(), exp, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", SCAN_SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_function_wires_the_plain_callees_like_autograd(shape):
    """``SlstmScan.apply`` with the plain saving forward and reverse scan:
    the forward's h bit-equal to the plain version's, the gradients within
    atol 1e-5 of autograd's; only the inputs that need one get one."""
    pre, r, w = _inputs(*shape, seed=2)
    h = shape[3]
    tp, tr = (torch.from_numpy(a).requires_grad_() for a in (pre, r))
    out = tss.SlstmScan.apply(tp, tr, h, tss.slstm_scan_saving_plain, tss.slstm_scan_bwd_plain)
    assert torch.equal(out, tss.slstm_scan_plain(tp, tr, h))
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tp, tr))
    for g, exp in zip(got, _autograd(pre, r, w, h)):
        np.testing.assert_allclose(g.numpy(), exp.numpy(), atol=ATOL, rtol=0)
    tr_frozen = torch.from_numpy(r)
    out = tss.SlstmScan.apply(tp, tr_frozen, h, tss.slstm_scan_saving_plain,
                              tss.slstm_scan_bwd_plain)
    (g,) = torch.autograd.grad(out.sum(), (tp,))
    assert g.shape == tp.shape


def test_function_casts_for_bf16_pre_and_r():
    """bf16 pre and r: the state is f32, so the reverse scan runs on the f32
    saves; dpre is dz rounded once to bf16 (bit for bit), dR the f32 product
    rounded once (within a bf16 ulp), and both agree with autograd of the
    f32 scan on the widened inputs."""
    t, b, d, h = 12, 3, 32, 2
    pre, r, w = _inputs(t, b, d, h, seed=3)
    pb = torch.from_numpy(pre).to(torch.bfloat16).requires_grad_()
    rb = torch.from_numpy(r).to(torch.bfloat16).requires_grad_()
    wb = torch.from_numpy(w).to(torch.bfloat16)
    out = tss.SlstmScan.apply(pb, rb, h, tss.slstm_scan_saving_plain, tss.slstm_scan_bwd_plain)
    assert out.dtype == torch.bfloat16
    dpre, dr = torch.autograd.grad(out, (pb, rb), grad_outputs=wb)
    assert dpre.dtype == dr.dtype == torch.bfloat16
    # the f32 reverse scan on the widened inputs, from the same f32 saves
    _, z, state = tss.slstm_scan_saving_plain(pb.detach().float(), rb.detach().float(), h)
    dz = tss.slstm_scan_bwd_plain(wb.float(), rb.detach().float(), z, state, h)
    assert torch.equal(dpre, dz.to(torch.bfloat16))
    dr32 = tss.recurrent_weight_grad(state[0], dz, h)
    ulp = torch.finfo(torch.bfloat16).eps * dr32.abs().clamp_min(1e-30)
    assert bool(((dr.float() - dr32).abs() <= ulp).all())
    want = _autograd(pb.detach().float().numpy(), rb.detach().float().numpy(),
                     wb.float().numpy(), h)
    for got, exp in zip((dz, dr32), want):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=ATOL, rtol=0)


def test_minus_inf_input_gate():
    """An input gate of -inf (at the first step, and once later): the
    gradients are NaN or finite where autograd of the plain version and
    ``jax.grad`` of the reference have them, and agree elsewhere."""
    pre, r, w = _inputs(4, 2, 16, 2, seed=11)
    pre[0, :, :3] = -np.inf
    pre[2, 1, 5] = -np.inf
    got = _reverse_scan(pre, r, w, 2)
    for g, exp in zip(got, _autograd(pre, r, w, 2)):
        np.testing.assert_allclose(g.numpy(), exp.numpy(), atol=ATOL, rtol=0, equal_nan=True)
    for g, exp in zip(got, _jax_grad(pre, r, w, 2)):
        np.testing.assert_allclose(g.numpy(), exp, atol=ATOL, rtol=0, equal_nan=True)


def test_stabilizer_tie_matches_autograd():
    """With R = 0 the scan's z is pre, so pre can put lf + m_{t-1} and li
    on the same float at step 1 (m_0 = li_0), where ``torch.maximum`` gives
    each side half of m's gradient: the reverse scan's tie (a == li, both
    halves) agrees with autograd and ``jax.grad``.  At a tie i = f = 1 and
    n >= 1, where h does not depend on the stabilizer, so m's total
    gradient is zero up to rounding there and another split would agree as
    well: the test holds the tie's path, not the split's share."""
    t, b, d, h = 3, 1, 4, 1
    pre, _, w = _inputs(t, b, d, h, seed=4)
    r = np.zeros((h, d // h, 4 * d // h), np.float32)
    pre[0, 0, :d] = 0.5                                   # li_0, so m_0 = 0.5
    pre[1, 0, d:2 * d] = 0.0                              # lf_raw_1
    lf = F.logsigmoid(torch.zeros(d)).numpy()
    pre[1, 0, :d] = lf + np.float32(0.5)                  # li_1 = lf_1 + m_0
    tp, tr = torch.from_numpy(pre), torch.from_numpy(r)
    _, z, state = tss.slstm_scan_saving_plain(tp, tr, h)
    a = F.logsigmoid(z[1, 0, d:2 * d]) + state[3, 0, 0]
    assert torch.equal(a, z[1, 0, :d])                    # the tie holds
    dpre, dr = _reverse_scan(pre, r, w, h)
    want = _autograd(pre, r, w, h)
    for got, exp in zip((dpre, dr), want):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), atol=ATOL, rtol=0)
    for got, exp in zip((dpre, dr), _jax_grad(pre, r, w, h)):
        np.testing.assert_allclose(got.numpy(), exp, atol=ATOL, rtol=0)


def test_first_step_starts_from_the_reference_state():
    """At t = 0 the state before is (c, n, m) = (0, 0, -1e30): f = 0, n_0 =
    1 exactly (the clamp's tie), and the gradient of lf_raw at t = 0 is 0
    (nothing flows through f = 0)."""
    pre, r, w = _inputs(5, 2, 16, 2, seed=5)
    _, z, state = tss.slstm_scan_saving_plain(torch.from_numpy(pre), torch.from_numpy(r), 2)
    assert torch.equal(state[2, 0], torch.ones_like(state[2, 0]))
    dpre, _ = _reverse_scan(pre, r, w, 2)
    assert torch.equal(dpre[0, :, 16:32], torch.zeros_like(dpre[0, :, 16:32]))
    assert bool(torch.isfinite(dpre).all())


def test_saving_forward_keeps_the_scan_state():
    """``slstm_scan_saving_plain``'s saves: z = pre + rec(h_{t-1}) and the
    state after each step, h equal to the output in f32."""
    pre, r, _ = _inputs(6, 3, 32, 4, seed=6)
    tp, tr = torch.from_numpy(pre), torch.from_numpy(r)
    out, z, state = tss.slstm_scan_saving_plain(tp, tr, 4)
    assert z.shape == (6, 3, 128) and state.shape == (4, 6, 3, 32)
    assert torch.equal(out, state[0])
    assert torch.equal(z[0], tp[0])
    for t in range(1, 6):
        np.testing.assert_allclose(z[t].numpy(), (tp[t] + tss.recurrent(state[0, t - 1], tr))
                                   .numpy(), atol=0, rtol=0)


def test_backward_launcher_refuses_what_it_does_not_take():
    """The kernel's launcher takes contiguous tensors on the card (a CPU
    tensor raises before any build), one dtype for dout and r, and a
    scan's saves."""
    t, b, d, h = 4, 2, 16, 2
    dout = torch.zeros((t, b, d))
    r = torch.zeros((h, d // h, 4 * d // h))
    z = torch.zeros((t, b, 4 * d))
    state = torch.zeros((4, t, b, d))
    with pytest.raises(ValueError, match="CUDA"):
        tss.slstm_scan_bwd(dout, r, z, state, h)
    meta = {k: v.to("meta") for k, v in dict(dout=dout, r=r, z=z, state=state).items()}
    with pytest.raises(ValueError, match="CUDA"):
        tss.slstm_scan_bwd(meta["dout"], meta["r"], meta["z"], meta["state"], h)
    with pytest.raises(ValueError, match=r"state \(4, T, B, d\)"):
        tss.check_saved(dout, r, z, state[:3], h)
    with pytest.raises(ValueError, match="f32"):
        tss.check_saved(dout, r, z.double(), state, h)


def _saves(device):
    t, b, d, h = 4, 2, 16, 2
    return (torch.zeros((t, b, d), device=device), torch.zeros((h, d // h, 4 * d // h),
                                                               device=device),
            torch.zeros((t, b, 4 * d), device=device), torch.zeros((4, t, b, d), device=device),
            h)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("route", [None, tss.PERSISTENT, tss.STEP])
def test_backward_launcher_refuses_a_tensor_off_the_card_on_each_route(route, device):
    """A CPU or meta tensor raises before any build (the fixture refuses
    ``build.load``), whatever the route asked for, and counts no launch."""
    tbuild.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tss.slstm_scan_bwd(*_saves(device), route=route)
    assert not any(tbuild.LAUNCHES.values())


@pytest.mark.parametrize("route", ["fast", "PERSISTENT", ""])
def test_backward_launcher_refuses_an_unknown_route(route):
    with pytest.raises(ValueError, match="unknown route"):
        tss.slstm_scan_bwd(*_saves("cpu"), route=route)


def test_ops_sends_a_gradient_through_the_function_off_the_cpu(monkeypatch):
    """On a tensor off the CPU that needs a gradient, ``ops.slstm_scan``
    takes ``SlstmScan`` with the kernels: the saving forward's launcher
    refuses a tensor that is not on the card (no plain fallback).  Meta
    tensors stand for a card's with the meta rule switched off."""
    pre = torch.empty((4, 2, 64), device="meta", requires_grad=True)
    r = torch.empty((2, 8, 32), device="meta")
    for module in (tops, tss):
        monkeypatch.setattr(module, "is_meta", lambda *tensors: False)
    calls = []
    real = tss.SlstmScan.apply

    def spy(*args):
        calls.append(args[3:])
        return real(*args)

    monkeypatch.setattr(tss.SlstmScan, "apply", spy)
    with pytest.raises(ValueError, match="CUDA"):
        tops.slstm_scan(pre, r, 2)
    assert calls == [(tss.slstm_scan_saving, tss.slstm_scan_bwd)]
