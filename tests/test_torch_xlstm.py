"""Parity of the port's xLSTM serve path with the JAX reference on the CPU:
B7's plain version (the sLSTM time scan a CPU tensor takes) against
``ref.slstm_scan_reference`` and the Pallas kernel in interpret mode, the
gate layout, the mLSTM and sLSTM mixers and their decode steps, and the
model (``arch_type="ssm"`` with ``slstm_every``): plan, converted init,
forward, prefill, decode with its caches, the greedy serve loop, the split
view, and the CPU loss and gradients.

Tolerances: the scan atol 1e-5 in f32 (the two frameworks sum the
recurrent product in different orders); with bf16 pre and r, 8e-3, two
bf16 steps at |h| <= 1 (the f32 state is the same, only the last rounding
of h to bf16 may fall on the other side).  Mixers atol 1e-4, the bound of
``tests/test_models.py``'s xLSTM tests; hidden states and prefill logits
1e-4, decode logits and every cache leaf 2e-4, as ``tests/test_torch_lm.py``;
greedy tokens exactly equal; the loss and each gradient within rel 1e-4 of
``jax.grad`` of the reference.  The CUDA kernel runs only on the card
(``chip_smoke.py`` phase 1 holds it against the plain version)."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtfm
from repro.models import xlstm as jx
from repro.models.model import build_plan as jax_build_plan
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_split_to_reference,
                                 lm_to_reference)
from repro_torch.data import make_markov_tokens
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slstm_scan as tss
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models import xlstm as tx
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_plan
from _torch_threads import one_thread  # noqa: F401

SCAN_ATOL = {"float32": 1e-5, "bfloat16": 8e-3}
MIXER_ATOL = 1e-4
FORWARD_ATOL = 1e-4
DECODE_ATOL = 2e-4
GRAD_REL = 1e-4
# (T, B, d, H): tests/test_kernels.py's shapes, dh 40, and a single step
SCAN_SHAPES = [(16, 2, 32, 2), (32, 1, 64, 4), (8, 4, 16, 1), (9, 3, 80, 2), (1, 1, 8, 1)]
B, S = 2, 32
PROMPT, NEW = 8, 8


def _scan_inputs(t, b, d, h, seed=0):
    rng = np.random.default_rng(seed)
    dh = d // h
    pre = rng.normal(size=(t, b, 4 * d)).astype(np.float32)
    r = (rng.normal(size=(h, dh, 4 * dh)) / np.sqrt(dh)).astype(np.float32)
    return pre, r


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


# ---------------------------------------------------------------------------
# B7: the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scan_plain_matches_reference(shape, dtype):
    t, b, d, h = shape
    pre, r = _scan_inputs(*shape)
    jdt = getattr(jnp, dtype)
    want = ref.slstm_scan_reference(jnp.asarray(pre, jdt), jnp.asarray(r, jdt), n_heads=h)
    tdt = getattr(torch, dtype)
    got = tops.slstm_scan(torch.from_numpy(pre).to(tdt), torch.from_numpy(r).to(tdt), h)
    assert got.shape == (t, b, d) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=SCAN_ATOL[dtype], rtol=0)


def test_scan_plain_matches_the_pallas_kernel():
    pre, r = _scan_inputs(16, 2, 32, 2, seed=3)
    want = jops.slstm_scan(jnp.asarray(pre), jnp.asarray(r), n_heads=2, interpret=True)
    got = tss.slstm_scan_plain(torch.from_numpy(pre), torch.from_numpy(r), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SCAN_ATOL["float32"],
                               rtol=0)


def _per_head_reading(pre, r, n_heads):
    """The scan as the reference kernel's docstring reads ("gates [i, f, z,
    o] per head"): head j's R feeds the four gates of head j's units.  Not
    what the reference computes, except at H = 1."""
    t, b, d4 = pre.shape
    d = d4 // 4
    dh = d // n_heads
    h = c = n = torch.zeros((b, d))
    m = torch.full((b, d), tss.M_INIT)
    outs = []
    for step in range(t):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, n_heads, dh), r)   # (B, H, 4dh)
        rec = rec.reshape(b, n_heads, 4, dh).transpose(1, 2).reshape(b, 4 * d)
        h, c, n, m = tss.slstm_gates(pre[step] + rec, c, n, m)
        outs.append(h)
    return torch.stack(outs)


@pytest.mark.parametrize("n_heads", [1, 2, 4])
def test_gate_layout_is_head_major(n_heads):
    """Head j's R feeds the z columns [j 4dh, (j+1) 4dh): at H = 4 gate j of
    every unit, at H = 2 two whole gates.  Zeroing one head moves those
    columns only, yet h in every unit; the per-head reading agrees with the
    reference at H = 1 only."""
    d = 16
    dh = d // n_heads
    pre, r = (torch.from_numpy(a) for a in _scan_inputs(3, 1, d, n_heads, seed=7))
    h = torch.from_numpy(np.random.default_rng(8).normal(size=(1, d)).astype(np.float32))
    for head in range(n_heads):
        cut = r.clone()
        cut[head] = 0.0
        moved = (tss.recurrent(h, cut) != tss.recurrent(h, r))[0]
        cols = torch.zeros(4 * d, dtype=torch.bool)
        cols[head * 4 * dh:(head + 1) * 4 * dh] = True
        assert torch.equal(moved, cols), head
        h1 = tss.slstm_scan_plain(pre, cut, n_heads)[1]
        assert bool((h1 != tss.slstm_scan_plain(pre, r, n_heads)[1]).all()), head
    want = np.asarray(ref.slstm_scan_reference(jnp.asarray(pre.numpy()),
                                               jnp.asarray(r.numpy()), n_heads=n_heads))
    per_head = _per_head_reading(pre, r, n_heads).numpy()
    assert np.allclose(per_head, want, atol=SCAN_ATOL["float32"]) == (n_heads == 1)


def test_scan_first_step_and_minus_inf_input_gate():
    """m starts at -1e30, so f = 0 at t = 0 with no inf - inf, and an input
    gate of -inf stays finite (i = 0, the state keeps f = 1)."""
    pre, r = _scan_inputs(4, 2, 16, 2, seed=11)
    pre[0, :, :3] = -np.inf                 # li of units 0-2 at the first step
    pre[2, 1, 5] = -np.inf                  # and of one unit later on
    want = np.asarray(ref.slstm_scan_reference(jnp.asarray(pre), jnp.asarray(r), n_heads=2))
    got = tss.slstm_scan_plain(torch.from_numpy(pre), torch.from_numpy(r), 2).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=SCAN_ATOL["float32"], rtol=0)
    np.testing.assert_array_equal(got[0, :, :3], 0.0)


def test_scan_dispatch_raises_off_the_cpu(monkeypatch):
    """A tensor off the CPU takes the kernels or raises: with a gradient the
    saving forward of B7's autograd Function, without one the plain
    launcher; both refuse a tensor that is not on the card.  Meta tensors
    stand for a card's with the meta rule switched off (with it, they get
    empty outputs of the kernel's shapes, ``tests/test_torch_dryrun.py``)."""
    pre = torch.empty((4, 2, 64), device="meta", requires_grad=True)
    r = torch.empty((2, 8, 32), device="meta")
    assert tops.slstm_scan(pre, r, 2).shape == (4, 2, 16)
    for module in (tops, tss):
        monkeypatch.setattr(module, "is_meta", lambda *tensors: False)
    with pytest.raises(ValueError, match="CUDA"):
        tops.slstm_scan(pre, r, 2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tops.slstm_scan(pre, r, 2)
    with pytest.raises(ValueError, match="not \\(H, dh, 4dh\\)"):
        tss.slstm_scan_plain(torch.zeros((4, 2, 64)), torch.zeros((2, 8, 8)), 2)


def test_scan_plain_gradient_matches_jax_grad():
    """What a CPU tensor trains through: autograd of the plain version."""
    pre, r = _scan_inputs(6, 2, 16, 2, seed=12)
    w = np.random.default_rng(13).normal(size=(6, 2, 16)).astype(np.float32)

    def jloss(p, rr):
        return jnp.sum(ref.slstm_scan_reference(p, rr, n_heads=2) * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(pre), jnp.asarray(r))
    tp, tr = (torch.from_numpy(a).requires_grad_() for a in (pre, r))
    tg = torch.autograd.grad((tops.slstm_scan(tp, tr, 2) * torch.from_numpy(w)).sum(),
                             (tp, tr))
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the mixers
# ---------------------------------------------------------------------------

def _load(module, tree):
    """Copy a reference mixer's parameter pytree into ``module`` by path."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.from_numpy(np.array(leaf, dtype=np.float32)))
    return module


def _mixers(kind, **cfg_kw):
    jcfg = jx.XLSTMConfig(d_model=32, n_heads=2, **cfg_kw)
    init = jx.mlstm_init if kind == "mlstm" else jx.slstm_init
    params = init(jax.random.PRNGKey(0), jcfg)
    # the reference's slstm_unroll only unrolls the same scan: the port has
    # no such field
    tcfg = tx.XLSTMConfig(**{k: v for k, v in jcfg._asdict().items() if k != "slstm_unroll"})
    module = (tx.MLSTM if kind == "mlstm" else tx.SLSTM)(tcfg)
    return jcfg, params, _load(module, params)


def _x(s=16, seed=1):
    return np.random.default_rng(seed).normal(size=(2, s, 32)).astype(np.float32)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_mlstm_forward_matches_reference(state_dtype, monkeypatch):
    """With ``state_dtype="bfloat16"`` the reference's einsums take bf16
    operands with ``preferred_element_type=f32``, which JAX's CPU backend
    cannot run (no BF16 x BF16 = F32 dot); the test widens those operands
    to f32 first, the same arithmetic (a bf16 product is exact in f32, the
    sum f32 either way).  The reference runs op by op: compiled, XLA's
    excess-precision rule may drop the bf16 roundings its casts write."""
    real = jnp.einsum

    def einsum(spec, *operands, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32) for o in operands]
        return real(spec, *operands, preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jx.jnp, "einsum", einsum)
    jcfg, params, mixer = _mixers("mlstm", chunk=4, state_dtype=state_dtype)
    x = _x()
    with jax.disable_jit():
        want = jx.mlstm_forward(params, jcfg, jnp.asarray(x))
    got = mixer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MIXER_ATOL,
                               rtol=0)


def test_mlstm_forward_refuses_a_ragged_last_chunk():
    _, _, mixer = _mixers("mlstm", chunk=4)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        mixer(torch.from_numpy(_x(s=6)))
    assert mixer(torch.from_numpy(_x(s=3))).shape == (2, 3, 32)      # one short chunk


def _carried(jcfg, params, kind, steps=5):
    """A reference decode cache after ``steps`` steps, and the next input."""
    decode = jx.mlstm_decode if kind == "mlstm" else jx.slstm_decode
    init = jx.init_mlstm_cache if kind == "mlstm" else jx.init_slstm_cache
    x = jnp.asarray(_x(s=steps + 1, seed=4))
    cache = init(2, jcfg)
    for t in range(steps):
        _, cache = decode(params, jcfg, x[:, t:t + 1], cache)
    return cache, x[:, steps:]


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_from_a_carried_cache_matches_reference(kind):
    jcfg, params, mixer = _mixers(kind)
    jcache, x = _carried(jcfg, params, kind)
    decode = jx.mlstm_decode if kind == "mlstm" else jx.slstm_decode
    want, want_cache = decode(params, jcfg, x, jcache)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    with torch.no_grad():
        got = mixer.decode(torch.from_numpy(np.array(x)), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MIXER_ATOL, rtol=0)
    assert set(tcache) == set(want_cache)
    for name, value in want_cache.items():
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(value), atol=MIXER_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("unroll", [1, 4])
def test_slstm_forward_matches_reference(unroll):
    """The port's one scan against the reference's, plain and unrolled 4
    steps a scan body."""
    jcfg, params, mixer = _mixers("slstm", slstm_unroll=unroll)
    x = _x()
    want = jx.slstm_forward(params, jcfg, jnp.asarray(x))
    got = mixer(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=MIXER_ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_the_forward(kind):
    """``tests/test_models.py``'s recurrences, on the port: the decode steps
    over S give the chunked mLSTM forward and the sLSTM scan."""
    _, _, mixer = _mixers(kind, chunk=4)
    x = torch.from_numpy(_x())
    with torch.no_grad():
        full = mixer(x)
        if kind == "mlstm":
            steps = tx.mlstm_forward_reference(mixer, x)
        else:
            cache = {k: v[0] for k, v in tx.init_slstm_cache(2, mixer.cfg).items()}
            steps = torch.cat([mixer.decode(x[:, t:t + 1], cache) for t in range(x.shape[1])],
                              dim=1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), atol=MIXER_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _smoke(**changes):
    return dataclasses.replace(jconfigs.get_smoke_config("xlstm-1.3b"), **changes)


# smoke: one mlstm and one slstm stack, one chunk of 64; 4x2: (m1 s1) x 2
# with two chunks a sequence; cut: m2 s1 m1, the split inside the first
# mLSTM stack
CASES = {"smoke": lambda: _smoke(),
         "4x2": lambda: _smoke(n_layers=4, slstm_every=2, ssm_chunk=16),
         "cut": lambda: _smoke(n_layers=4, slstm_every=3, ssm_chunk=16, cut_layer=1)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(jax model, jax params, port model, tokens (B, S)) from the
    reference's init, carried across by convert.py."""
    cfg = CASES[request.param]()
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(_port_cfg(cfg), _np_tree(params))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return jmodel, params, tmodel, tokens


def test_plan_matches_reference(pair):
    jmodel, _, tmodel, _ = pair
    assert ([(sp.kind, sp.n, sp.meta) for sp in tmodel.plan]
            == [(sp.kind, sp.n, sp.meta) for sp in jax_build_plan(jmodel.cfg)])
    assert [s.kind for s in tmodel.stacks] == [sp.kind for sp in tmodel.plan]


def test_full_config_plan_and_parameter_count():
    cfg = tserve.serve_config("xlstm-1.3b", full=True)
    assert cfg.dtype == "bfloat16" and cfg.ssm_chunk == 256
    plan = build_plan(cfg)
    assert [(sp.kind, sp.n) for sp in plan] == [("mlstm", 7), ("slstm", 1)] * 6
    assert ([(sp.kind, sp.n) for sp in plan]
            == [(sp.kind, sp.n) for sp in jax_build_plan(jconfigs.get_config("xlstm-1.3b"))])
    model = Model(cfg, plan, device="meta")                  # nothing allocated
    assert sum(p.numel() for p in model.parameters()) == 3_529_644_368
    r = model.stacks[1].layers[0].mixer.r
    assert tuple(r.shape) == (4, 512, 2048) and r.dtype == torch.bfloat16
    client, ap, slices = model.split_plans()
    assert slices[2] == (2, 4, 7)                            # cut_layer 12: mlstm 7 + slstm 1 + 4
    assert [(sp.kind, sp.n) for sp in client] == [("mlstm", 7), ("slstm", 1), ("mlstm", 4)]
    assert [(sp.kind, sp.n) for sp in ap[:2]] == [("mlstm", 3), ("slstm", 1)]


def test_convert_round_trip_is_exact(pair):
    _, params, tmodel, _ = pair
    back = lm_to_reference(tmodel)
    want = _np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_forward_and_prefill_match_reference(pair):
    jmodel, params, tmodel, tokens = pair
    jh, _ = jax.jit(jmodel.forward)(params, {"tokens": jnp.asarray(tokens)})
    th, aux = tmodel({"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=FORWARD_ATOL, rtol=0)
    jl = jax.jit(jax_prefill_step(jmodel))(params, {"tokens": jnp.asarray(tokens)})
    tl = make_prefill_step(tmodel)({"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (B, 1, jmodel.cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FORWARD_ATOL, rtol=0)


def test_decode_logits_and_caches_match_reference(pair):
    jmodel, params, tmodel, tokens = pair
    jstep = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(B, S)
    tcache = tmodel.init_cache(B, S)
    step = make_serve_step(tmodel)
    for i in range(S):
        jl, jcache = jstep(params, jcache, jnp.asarray(tokens[:, i:i + 1]), i)
        tl, tcache = step(tcache, torch.from_numpy(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=DECODE_ATOL, rtol=0)
    for jc, tc in zip(jcache, tcache):
        assert set(tc) == set(jc)
        for name, value in jc.items():
            assert tuple(tc[name].shape) == value.shape and tc[name].dtype == torch.float32
            np.testing.assert_allclose(tc[name].numpy(), np.asarray(value), atol=DECODE_ATOL,
                                       rtol=0, err_msg=name)


def _jax_serve_loop(jmodel, params, prompts, new_tokens):
    """The reference serve loop (``repro/launch/serve.py``)."""
    decode = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(prompts.shape[0], prompts.shape[1] + new_tokens)
    for i in range(prompts.shape[1]):
        logits, cache = decode(params, cache, jnp.asarray(prompts[:, i:i + 1]), i)
    generated = []
    for j in range(new_tokens):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        generated.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, prompts.shape[1] + j)
    return np.concatenate(generated, axis=1)


def test_serve_loop_tokens_equal_reference(pair):
    jmodel, params, tmodel, _ = pair
    prompts = make_markov_tokens(3, jmodel.cfg.vocab, B, PROMPT)
    want = _jax_serve_loop(jmodel, params, prompts, NEW)
    got, _ = tserve.greedy_decode(make_serve_step(tmodel), tmodel.init_cache(B, PROMPT + NEW),
                                  torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_view_matches_reference(pair):
    """gamma/phi at ``cut_layer`` (inside the first mLSTM stack for the
    'cut' case): the reference's ``split_params`` trees exactly, the cut
    activations within the forward bound, and ``merge_params`` the model's
    own parameters."""
    jmodel, params, tmodel, tokens = pair
    gamma, phi = tmodel.split_params()
    jgamma, jphi = jmodel.split_params(params)
    got = lm_split_to_reference(tmodel, gamma, phi)
    for mine, want in zip(got, (jgamma, jphi)):
        assert jax.tree.structure(mine) == jax.tree.structure(_np_tree(want))
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    acts = jax.jit(jmodel.client_forward)(jgamma, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        tacts = tmodel.client_forward(gamma, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tacts.numpy(), np.asarray(acts), atol=FORWARD_ATOL, rtol=0)
    merged = tmodel.merge_params(gamma, phi)
    assert all(a is b for a, b in zip(merged.parameters(), tmodel.parameters()))


def test_loss_and_every_gradient_match_reference():
    """``Model.loss`` and its gradients on the CPU (the plain scan under
    autograd) against ``jax.grad`` of the reference, each leaf within rel
    1e-4 of its largest value."""
    cfg = CASES["4x2"]()
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2))
    tmodel = lm_from_reference(_port_cfg(cfg), _np_tree(params))
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(params, jbatch)
    tloss, _ = tmodel.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(tloss, list(tmodel.parameters()))
    assert abs(float(tloss.detach()) - float(jloss)) <= GRAD_REL * abs(float(jloss))
    holder = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    got = lm_to_reference(holder)
    assert jax.tree.structure(got) == jax.tree.structure(_np_tree(jgrads))
    for (path, g), want in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree.leaves(jgrads)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g - want).max()) / scale
        assert err <= GRAD_REL, f"{jax.tree_util.keystr(path)}: rel err {err:.3e}"


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--device", "cpu", "--arch", "xlstm-1.3b", "--batch", "2",
                 "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b-smoke batch=2 prompt=4 new=3" in out and "(CPU)" in out


def test_mamba_still_names_the_ssm_slice():
    """``arch_type="ssm"`` without ``slstm_every`` is Mamba2, ported with the
    SSM slice (``tests/test_torch_ssm.py``): xLSTM's smoke config with
    ``slstm_every = 0`` builds one ``mamba`` stack, the reference's plan,
    and its loss matches the reference's from the reference's init."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("xlstm-1.3b"), slstm_every=0)
    cfg = dataclasses.replace(tconfigs.get_smoke_config("xlstm-1.3b"), slstm_every=0)
    assert [(sp.kind, sp.n) for sp in build_model(cfg, "cpu").plan] == \
        [(sp.kind, sp.n) for sp in jax_build_plan(jcfg)] == [("mamba", cfg.n_layers)]
    jmodel = jax_build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(4))
    tmodel = lm_from_reference(cfg, jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    want, _ = jmodel.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = tmodel.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)


# ---------------------------------------------------------------------------
# bf16 at full depth
# ---------------------------------------------------------------------------

# xLSTM-1.3B's 48 blocks in 12 stacks (slstm_every 8) at d_model 64 in bf16,
# the dtype the port serves; prompts of two mLSTM chunks
DEEP_S = 8
# a port block fed the reference's input lands within one bf16 ulp of the
# block's largest output, and the blocks' outputs differ, on average over
# the blocks, in at most this share of their elements: an f32 sum in
# another order puts a rounding on the other side now and then; a cast in
# another place, or a silu rounded otherwise, moves a large share
DEEP_BLOCK_SHARE = 0.02


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp at x's largest magnitude (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def _rel(a, b) -> float:
    """max |a - b| over max |a|."""
    return float(np.abs(a - b).max() / np.abs(a).max())


def _silu_rounded_once(x):
    """silu in f32, rounded once to x's dtype, as torch computes it.  JAX's
    CPU backend evaluates a bf16 silu less exactly (see
    test_the_rounded_silu_is_torchs)."""
    return (x.astype(jnp.float32) * jax.nn.sigmoid(x.astype(jnp.float32))).astype(x.dtype)


def test_the_rounded_silu_is_torchs():
    """The reference's silu rounded once equals torch's bf16 silu bit for
    bit; JAX's own CPU bf16 silu lies an ulp or more off in some of its
    values (printed), so the full-depth comparison below rounds it once."""
    x = np.random.default_rng(10).normal(scale=3.0, size=(100_000,)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = torch.nn.functional.silu(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(np.asarray(_silu_rounded_once(xj), np.float32), want)
    own = np.asarray(jax.nn.silu(xj), np.float32)
    ulps = np.abs((own.view(np.int32) >> 16) - (want.view(np.int32) >> 16))
    print(f"JAX's bf16 silu on the CPU: {np.mean(ulps > 0):.2%} of {x.size} values off, "
          f"by at most {int(ulps.max())} bf16 ulps")


def _serve_logits(prefill, step, cache, tokens):
    """Last-position logits (B, V) f32 of the prefill and of the decode
    steps over the prompt."""
    pre = prefill(tokens)
    for i in range(tokens.shape[1]):
        logits, cache = step(cache, tokens[:, i:i + 1], i)
    return np.asarray(pre, np.float32)[:, -1], np.asarray(logits, np.float32)[:, -1]


@pytest.fixture(scope="module")
def deep():
    """The reference and the port on the same bf16 weights, and on them
    widened to f32: each one's prefill and decode logits; the reference's
    bf16 run op by op with its silu rounded once, recording each block's
    input and output on the prefill path and each mixer's at every decode
    step."""
    base = jconfigs.reduce_config(jconfigs.get_config("xlstm-1.3b"), n_layers=48,
                                  d_model=64, vocab=256)
    cfgs = {dt: dataclasses.replace(base, dtype=dt, ssm_chunk=DEEP_S // 2, slstm_every=8)
            for dt in ("bfloat16", "float32")}
    jmodels = {dt: jax_build_model(c) for dt, c in cfgs.items()}
    params16 = jax.jit(jmodels["bfloat16"].init)(jax.random.PRNGKey(0))
    params = {"bfloat16": params16,
              "float32": jax.tree.map(lambda a: a.astype(jnp.float32), params16)}
    tokens = np.random.default_rng(9).integers(0, base.vocab, size=(B, DEEP_S)).astype(np.int32)
    out = {"tokens": tokens}
    for dt, jm in jmodels.items():
        # the reference as its serve path runs it: compiled
        prefill = jax.jit(jax_prefill_step(jm))
        step = jax.jit(jm.decode_step)
        out["ref", dt] = _serve_logits(
            lambda t: prefill(params[dt], {"tokens": jnp.asarray(t)}),
            lambda c, t, i: step(params[dt], c, jnp.asarray(t), i),
            jm.init_cache(B, DEEP_S), tokens)
        tm = lm_from_reference(_port_cfg(cfgs[dt]), _np_tree(params[dt]))
        tprefill, tstep = make_prefill_step(tm), make_serve_step(tm)
        with torch.no_grad():
            out["port", dt] = _serve_logits(
                lambda t: tprefill({"tokens": torch.from_numpy(t)}),
                lambda c, t, i: tstep(c, torch.from_numpy(t), i),
                tm.init_cache(B, DEEP_S), tokens)
        out["model", dt] = tm
    jm = jmodels["bfloat16"]
    seen = {"forward": [], "decode": []}

    def recording(fn, where):
        def call(*args):
            y = fn(*args)
            seen[where].append((np.asarray(args[-2 if where == "decode" else -1],
                                           np.float32),
                                np.asarray(y[0] if where == "decode" else y, np.float32)))
            return y
        return call

    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jax.nn, "silu", _silu_rounded_once)
        for name in ("_mlstm_layer", "_slstm_layer"):
            mp.setattr(jtfm, name, recording(getattr(jtfm, name), "forward"))
        for name in ("mlstm_decode", "slstm_decode"):
            mp.setattr(jx, name, recording(getattr(jx, name), "decode"))
        out["ref_eager", "bfloat16"] = _serve_logits(
            lambda t: jax_prefill_step(jm)(params16, {"tokens": jnp.asarray(t)}),
            lambda c, t, i: jm.decode_step(params16, c, jnp.asarray(t), i),
            jm.init_cache(B, DEEP_S), tokens)
    n = jm.cfg.n_layers
    out["forward"] = seen["forward"]
    out["decode"] = [seen["decode"][i * n:(i + 1) * n] for i in range(DEEP_S)]
    return out


def test_bf16_full_depth_drifts_from_f32_as_the_reference_does(deep):
    """At full depth in bf16 the rounding compounds, block after block: the
    reference's own bf16 prefill and decode logits lie some way from its
    f32 logits of the same weights, and the port's lie as far (within a
    factor 2) from the port's f32 logits, which agree with the
    reference's."""
    for path, i in (("prefill", 0), ("decode", 1)):
        ref32, port32 = deep["ref", "float32"][i], deep["port", "float32"][i]
        np.testing.assert_allclose(port32, ref32, atol=FORWARD_ATOL, rtol=0, err_msg=path)
        ref_drift = _rel(ref32, deep["ref", "bfloat16"][i])
        port_drift = _rel(port32, deep["port", "bfloat16"][i])
        print(f"{path}: bf16 vs f32 logits, max |diff| / max |logit|: reference "
              f"{ref_drift:.4e}, port {port_drift:.4e}")
        assert ref_drift > 0.0 and port_drift <= 2.0 * ref_drift, (path, ref_drift, port_drift)


def test_bf16_full_depth_logits_match_reference(deep):
    """The port's bf16 prefill and decode logits against the reference's,
    its silu rounded once as torch rounds it: within half the reference's
    own bf16-vs-f32 drift (a lone rounding that lands on the other side
    compounds over the 48 blocks, as any bf16 rounding does)."""
    for path, i in (("prefill", 0), ("decode", 1)):
        want = deep["ref_eager", "bfloat16"][i]
        drift = _rel(deep["ref", "float32"][i], want)
        err = _rel(want, deep["port", "bfloat16"][i])
        print(f"{path}: port vs reference bf16 logits {err:.4e} (the reference's bf16 "
              f"drift from f32 {drift:.4e})")
        assert err <= 0.5 * drift, (path, err, drift)


def test_bf16_full_depth_blocks_match_reference(deep):
    """Each of the 48 blocks fed the reference's bf16 input on the prefill
    path, and each mixer at every decode step: within one bf16 ulp of the
    reference's output, and differing in at most DEEP_BLOCK_SHARE of the
    elements on average over the blocks."""
    tm = deep["model", "bfloat16"]
    layers = [(layer, k, j) for k, stack in enumerate(tm.stacks)
              for j, layer in enumerate(stack.layers)]
    assert len(layers) == len(deep["forward"]) == 48
    assert [len(seen) for seen in deep["decode"]] == [48] * DEEP_S
    cache = tm.init_cache(B, DEEP_S)
    checks = {"prefill": [], "decode": []}
    with torch.no_grad():
        for (layer, k, j), (x, y) in zip(layers, deep["forward"]):
            got = layer(torch.from_numpy(x).to(torch.bfloat16))
            checks["prefill"].append((f"block {k}.{j}", y, got.float().numpy()))
        for i, seen in enumerate(deep["decode"]):
            for (layer, k, j), (x, y) in zip(layers, seen):
                got = layer.mixer.decode(torch.from_numpy(x).to(torch.bfloat16),
                                         {name: t[j] for name, t in cache[k].items()})
                checks["decode"].append((f"step {i}, mixer {k}.{j}", y, got.float().numpy()))
    for path, found in checks.items():
        for what, want, got in found:
            assert float(np.abs(want - got).max()) <= _bf16_ulp(want), (path, what)
        share = float(np.mean([np.mean(want != got) for _, want, got in found]))
        print(f"{path}: blocks fed the reference's input differ in {share:.4%} of their "
              f"elements on average")
        assert share <= DEEP_BLOCK_SHARE, (path, share)
