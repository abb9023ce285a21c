"""The cluster-stacked LM (``models.StackedModel``) against the plain model
slot by slot, the stacked wire (``quant_cut_exchange`` over (R, B, S, d))
and B1's plain version on bf16 activations; the launch layer's round steps
over the stacked LM against the reference's (``launch/steps.py``:
``make_pigeon_round_step``, its block form,
``make_pigeon_plus_round_step``), ``RoundRunner.round`` in the protocol
layout, and ``input_specs`` on the meta device.

The tiny LM has 2 layers and d_model 64; the steps run on R = 2 slots, each
carrying one of two reference inits.  Tolerances, f32 throughout: a slot of
the stacked model is bit-equal to its plain model (the products run one a
slot on views of the stacked weights, and the slot-folded elementwise work
rounds alike on the CPU); B1's distances on bf16 within rtol 1e-6 of the
Pallas kernel's (f32 sums in two orders); the steps' ``sel`` equal,
``vlosses`` within rtol 1e-5 and every slot's parameters within atol 1e-6
of the reference's (one SGD step of lr 0.05 on the same f32 gradients up to
summation order), and every slot equal to the winner bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.runner as jrunner
from repro.launch import steps as jsteps
from repro.models import build_model as jax_build_model
from repro.models.config import ModelConfig as JModelConfig
from repro.kernels import ops as jops
import repro_torch.core as tcore
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_slot_to_reference,
                                 lm_split_from_reference, lm_stack_from_reference,
                                 lm_to_reference)
from repro_torch.core.runner import (RoundRunner, broadcast_winner, protocol_round_spec,
                                     sharded_validation_losses)
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import ModelConfig, build_model, build_stacked_model
from _torch_threads import one_thread  # noqa: F401

B1_RTOL = 1e-6
VLOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
LR = 0.05
TINY = dict(name="tiny-lm", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=64, cut_layer=1)
K, R, B, S, D_O = 2, 2, 4, 16, 8


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the stacked LM, slot by slot
# ---------------------------------------------------------------------------

SLOT_CASES = {"plain": dict(), "bias_norm_remat": dict(qkv_bias=True, qk_norm=True,
                                                        remat=True),
              "masked": dict(mask=True)}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_stacked_slot_is_bit_equal_to_its_plain_model(case):
    """Slot r of ``StackedModel.loss``, ``client_forward`` and both
    gradients (the loss's w.r.t. every parameter, the cut activations' for a
    given cut gradient) equal the plain model of slot r's parameters, bit
    for bit; the replica form (2 replicas of 2) computes the same."""
    kw = dict(SLOT_CASES[case])
    mask = kw.pop("mask", False)
    cfg = ModelConfig(**TINY, **kw)
    models = [build_model(cfg, "cpu").init(torch.Generator().manual_seed(s))
              for s in range(4)]
    stacked = build_stacked_model(cfg, 2, replicas=2, device="cpu")
    for r, m in enumerate(models):
        stacked.load_slot(r, m)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 64, (4, 2, 16)))
    batches = {"tokens": toks, "labels": torch.from_numpy(rng.integers(0, 64, (4, 2, 16)))}
    if mask:
        batches["mask"] = torch.from_numpy((rng.random((4, 2, 16)) > 0.3).astype(np.float32))
    losses = stacked.loss(batches)
    grads = torch.autograd.grad(losses.sum(), list(stacked.parameters()))
    gamma, _ = stacked.split_params()
    acts = stacked.client_forward(gamma, toks)
    g_cut = torch.from_numpy(rng.normal(size=tuple(acts.shape)).astype(np.float32))
    g_acts = torch.autograd.grad(acts, list(gamma.parameters()), grad_outputs=g_cut)
    assert losses.shape == (4,) and acts.shape == (4, 2, 16, 64)
    for r, m in enumerate(models):
        loss, _ = m.loss({k: v[r] for k, v in batches.items()})
        assert torch.equal(losses[r], loss), r
        for got, want in zip(grads, torch.autograd.grad(loss, list(m.parameters()))):
            assert torch.equal(got[r], want), r
        g, _ = m.split_params()
        a = m.client_forward(g, {"tokens": toks[r]})
        assert torch.equal(acts[r], a), r
        for got, want in zip(g_acts, torch.autograd.grad(a, list(g.parameters()),
                                                         grad_outputs=g_cut[r])):
            assert torch.equal(got[r], want), r


def test_stacked_halves_follow_the_plain_halves_order():
    """The ``StackedSplit`` contract: ``parameters()`` of each stacked half
    follow the plain half's order with the slot axis in front."""
    cfg = ModelConfig(**TINY, qkv_bias=True, qk_norm=True)
    module = tcore.from_lm(build_model(cfg, "cpu"))
    plain = module.init(torch.Generator().manual_seed(0))
    stacked = module.stacked.make(3)
    for p_half, s_half in zip(plain, stacked):
        pn = [(n, tuple(p.shape)) for n, p in p_half.named_parameters()]
        sn = [(n, tuple(p.shape)[1:]) for n, p in s_half.named_parameters()]
        assert pn == sn
        assert all(p.shape[0] == 3 for p in s_half.parameters())


def test_lm_stack_conversion_round_trip():
    """``lm_stack_from_reference`` puts tree r in slot r and
    ``lm_slot_to_reference`` takes it back exactly; ``broadcast_winner``
    copies one slot into every slot."""
    cfg = JModelConfig(**TINY)
    jm = jax_build_model(cfg)
    trees = [_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(s))) for s in (0, 1)]
    stacked = lm_stack_from_reference(ModelConfig(**TINY), trees)
    for r, tree in enumerate(trees):
        got = lm_slot_to_reference(stacked, r)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    broadcast_winner(stacked, torch.tensor(1))
    for a, b in zip(jax.tree.leaves(lm_slot_to_reference(stacked, 0)),
                    jax.tree.leaves(trees[1])):
        np.testing.assert_array_equal(a, b)
    assert all(torch.equal(p[0], p[1]) for p in stacked.parameters())
    # the plain model of a slot is the plain conversion of its tree
    for a, b in zip(stacked.slot_model(0).parameters(),
                    lm_from_reference(ModelConfig(**TINY), trees[1]).parameters()):
        assert torch.equal(a, b)
    assert jax.tree.structure(lm_to_reference(stacked.slot_model(0))) == \
        jax.tree.structure(trees[0])


def test_quant_cut_exchange_on_stacked_acts_is_a_row_a_sample():
    """(R, B, S, d) activations through the int8 wire with ``lead=2``: R * B
    per-sample rows, equal to R per-slot calls both ways (what the
    reference's vmap over clusters sends)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(3, 4, 8, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 4, 8, 16)).astype(np.float32))
    xs = x.clone().requires_grad_(True)
    y = tops.quant_cut_exchange(xs, "int8", lead=2)
    (gx,) = torch.autograd.grad(y, xs, grad_outputs=g)
    for r in range(3):
        xr = x[r].clone().requires_grad_(True)
        yr = tops.quant_cut_exchange(xr, "int8")
        (gr,) = torch.autograd.grad(yr, xr, grad_outputs=g[r])
        assert torch.equal(y[r], yr) and torch.equal(gx[r], gr)
    # R rows would share one scale a slot: not the same message
    assert not torch.equal(y, tops.quant_cut_exchange(x, "int8"))


@pytest.mark.parametrize("aliased", [False, True])
def test_b1_plain_on_bf16_matches_reference(aliased):
    """B1's plain version on bf16 activations (an LM's validation
    activations in the model's dtype, (R, D_o, S, d)) against the Pallas
    kernel in interpret mode, which casts each block to f32."""
    rng = np.random.default_rng(11)
    ref = np.maximum(rng.normal(size=(2, 4, 16, 32)), 0.0).astype(np.float32)
    recv = ref + (rng.normal(size=ref.shape) * np.array([0.0, 1e-2])[:, None, None, None])
    jref, jrecv = jnp.asarray(ref, jnp.bfloat16), jnp.asarray(recv, jnp.bfloat16)
    if aliased:
        jrecv = jref
    want = np.asarray(jax.vmap(lambda a, b: jops.tamper_distance(a, b, interpret=True))(
        jref, jrecv))
    tref = torch.from_numpy(np.array(jref.astype(jnp.float32))).to(torch.bfloat16)
    trecv = tref if aliased else torch.from_numpy(
        np.array(jrecv.astype(jnp.float32))).to(torch.bfloat16)
    got = tops.tamper_distance(tref, trecv)
    np.testing.assert_allclose(got.numpy(), want, rtol=B1_RTOL, atol=0)
    passed, _ = tops.tamper_verdict(tref, trecv, 1e-4)
    assert passed.tolist() == [True, aliased]
    if aliased:
        assert got.tolist() == [0.0, 0.0]


# ---------------------------------------------------------------------------
# the round steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inits():
    """The reference model, two of its inits stacked on a slot axis, and
    the inputs: K rounds of (R, B, S) batches, a (D_o, S) validation set and
    (R, B, S) Pigeon-SL+ batches."""
    jm = jax_build_model(JModelConfig(**TINY))
    trees = [jax.jit(jm.init)(jax.random.PRNGKey(s)) for s in (0, 1)]
    rng = np.random.default_rng(0)

    def batch(lead):
        return {name: rng.integers(0, TINY["vocab"], lead + (B, S)).astype(np.int32)
                for name in ("tokens", "labels")}

    return dict(jm=jm, trees=[_np_tree(t) for t in trees],
                stacked=jax.tree.map(lambda *xs: jnp.stack(xs), *trees),
                batches=batch((K, R)), val=batch((D_O // B,)), plus=batch((R,)))


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _val(inits):
    """The shared (D_o, S) validation batch."""
    return {k: v.reshape(D_O, S) for k, v in inits["val"].items()}


STEP_CASES = {"argmin": dict(), "int8": dict(quant="int8"),
              "median_of_means": dict(selection="median_of_means"),
              "block2": dict(block=2), "plus": dict(plus=True)}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_round_step_matches_reference(case, inits):
    """``vlosses``, ``sel`` and the slots' parameters after the round; every
    slot holds the winner."""
    kw = dict(STEP_CASES[case])
    plus, block = kw.pop("plus", False), kw.get("block", 1)
    model = lm_stack_from_reference(ModelConfig(**TINY), inits["trees"])
    batches = inits["batches"] if block > 1 else {k: v[0] for k, v in
                                                  inits["batches"].items()}
    val = _val(inits)
    if plus:
        jout = jax.jit(jsteps.make_pigeon_plus_round_step(inits["jm"], LR))(
            inits["stacked"], _jax(batches), _jax(val), _jax(inits["plus"]))
        vlosses, sel = tsteps.make_pigeon_plus_round_step(model, LR)(
            _torch(batches), _torch(val), _torch(inits["plus"]))
    else:
        jout = jax.jit(jsteps.make_pigeon_round_step(inits["jm"], LR, **kw))(
            inits["stacked"], _jax(batches), _jax(val))
        vlosses, sel = tsteps.make_pigeon_round_step(model, LR, **kw)(
            _torch(batches), _torch(val))
    jparams, (jv, js) = (jout[0], jout[1]) if block > 1 else (jout[0], jout[1:])
    assert vlosses.shape == ((K, R) if block > 1 else (R,))
    np.testing.assert_allclose(vlosses.numpy(), np.asarray(jv), rtol=VLOSS_RTOL, atol=0)
    assert sel.tolist() == np.asarray(js).tolist()
    last = sel[-1] if block > 1 else sel
    if not plus:
        assert int(last) == int(torch.argmin(vlosses[-1] if block > 1 else vlosses))
    for p in model.parameters():
        assert torch.equal(p[0], p[1])
    for r in range(R):
        got = lm_slot_to_reference(model, r)
        want = _np_tree(jax.tree.map(lambda x: x[r], jparams))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_round_step_rejects_what_the_reference_rejects(inits):
    """The launch spec has no message statistics, so ``loss_plus_distance``
    raises when the step is built (the reference when its step is traced); a block needs K rounds of batches; the mesh program raises."""
    model = lm_stack_from_reference(ModelConfig(**TINY), inits["trees"])
    with pytest.raises(ValueError, match="transmitted-message statistics"):
        tsteps.make_pigeon_round_step(model, LR, selection="loss_plus_distance")
    with pytest.raises(ValueError, match="transmitted-message statistics"):
        jax.eval_shape(jsteps.make_pigeon_round_step(inits["jm"], LR,
                                                     selection="loss_plus_distance"),
                       inits["stacked"], _jax({k: v[0] for k, v in inits["batches"].items()}),
                       _jax(_val(inits)))
    with pytest.raises(ValueError, match="block=0"):
        tsteps.make_pigeon_round_step(model, LR, block=0)
    with pytest.raises(ValueError, match="rounds of batches"):
        tsteps.make_pigeon_round_step(model, LR, block=3)(_torch(inits["batches"]),
                                                          _torch(_val(inits)))
    with pytest.raises(NotImplementedError, match="multi-card slice"):
        tsteps.make_pigeon_round_step_shardmap(model, None, LR)


def test_protocol_layout_round_broadcasts_the_argmin(inits):
    """``RoundRunner.round`` over the protocol spec (one theta into every
    slot): the candidates' vlosses, the argmin, and every slot of the
    returned stack equal to that candidate; ``round_block`` needs the
    stacked layout, the acceptance cascade the protocol layout."""
    module = tcore.from_lm(build_model(ModelConfig(**TINY), "cpu"))
    theta = module.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    xs = torch.from_numpy(rng.integers(0, 64, (R, 1, 2, B, S)))
    avec = tcore.ThreatModel().attack_vec_for_clusters([[0], [1]], 0)
    inputs = (xs, torch.roll(xs, 1, dims=-1), avec, np.arange(R).reshape(R, 1))
    val = (xs[0, 0, 0], torch.roll(xs[0, 0, 0], 1, dims=-1))
    runner = RoundRunner(protocol_round_spec(module, LR))
    (g, p), _, want_v, _ = runner.candidates(theta, inputs, val)
    want = [x[int(torch.argmin(want_v))].clone() for x in (*g.parameters(), *p.parameters())]
    (g, p), vlosses, sel = runner.round(theta, inputs, val)
    assert torch.equal(vlosses, want_v) and int(sel) == int(torch.argmin(want_v))
    for x, w in zip((*g.parameters(), *p.parameters()), want):
        assert all(torch.equal(x[r], w) for r in range(R))
    with pytest.raises(ValueError, match="params_stacked=True"):
        runner.round_block(theta, [inputs], val)
    with pytest.raises(ValueError, match="protocol layout"):
        RoundRunner(protocol_round_spec(module, LR), params_stacked=True).accept(
            theta, inputs, val)


def test_shard_losses_slice_the_lm_sample_axis(inits):
    """The median-of-means shards of an LM's (D_o, S, d) validation
    activations cut D_o, as the reference's reshape does (not S): the plain
    form (the host selector's) against the reference's
    ``sharded_validation_losses``, and the stacked form (the fused spec's,
    ``lead=1``) slot by slot against the plain one."""
    jm = inits["jm"]
    jg, jp = jm.split_params(jax.tree.map(jnp.asarray, inits["trees"][0]))
    rng = np.random.default_rng(5)
    acts = rng.normal(size=(D_O, S, TINY["d_model"])).astype(np.float32)
    y0 = rng.integers(0, TINY["vocab"], (D_O, S)).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, a, y: jrunner.sharded_validation_losses(
        jcore.from_lm(jm), p, a, y, 4))(jp, jnp.asarray(acts), jnp.asarray(y0)))
    cfg = ModelConfig(**TINY)
    _, phi = lm_split_from_reference(cfg, _np_tree(jg), _np_tree(jp))
    module = tcore.from_lm(build_model(cfg, "cpu"))
    ta, ty = torch.from_numpy(acts), torch.from_numpy(y0)
    with torch.no_grad():
        got = sharded_validation_losses(module.ap_loss, phi, ta, ty, 4)
        assert got.shape == (4,)
        np.testing.assert_allclose(got.numpy(), want, rtol=VLOSS_RTOL, atol=0)
        stacked = lm_stack_from_reference(cfg, inits["trees"][:1] * 2)
        _, sphi = stacked.split_params()
        rows = sharded_validation_losses(module.stacked.ap_losses, sphi,
                                         ta.expand((2,) + ta.shape),
                                         ty.expand((2,) + ty.shape), 4, lead=1)
    assert rows.shape == (2, 4) and torch.equal(rows[0], got) and torch.equal(rows[1], got)


def test_pigeon_batch_split_shapes():
    """The counterpart of ``tests/test_launch.py::test_pigeon_batch_split_shapes``:
    pigeon_batch_split gives each cluster global_batch / R, on the meta
    device."""
    cfg = tconfigs.get_smoke_config("h2o-danube-1.8b")
    full = tsteps.input_specs(cfg, "train_4k", pigeon_clusters=2)
    half = tsteps.input_specs(cfg, "train_4k", pigeon_clusters=2,
                              optimizations=("pigeon_batch_split",))
    assert full.args[0]["tokens"].shape == (2, 256, 4096)
    assert half.args[0]["tokens"].shape == (2, 128, 4096)
    assert full.args[1]["tokens"].shape == (32, 4096)
    for spec in (full, half):
        assert all(t.device.type == "meta" for t in spec.args[0].values())
        assert all(p.device.type == "meta" and p.shape[0] == 2
                   for p in spec.model.parameters())


@pytest.mark.parametrize("arch", ["qwen3-8b", "h2o-danube-1.8b", "xlstm-1.3b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "pigeon",
                                   "pigeon_plus"])
def test_input_specs_give_the_reference_shapes(arch, shape):
    """Every kind of step for the ported arch types, the xLSTM round over a
    cluster-stacked xLSTM among them: the argument shapes and dtypes of the
    reference's ``input_specs`` (its batch and val structs; the decode
    step's tokens, index and cache), as meta tensors.  ``pigeon_shardmap``
    raises."""
    from repro.configs import get_config as jget_config
    from repro.launch.shapes import SHAPES as JSHAPES
    cfg = tconfigs.get_config(arch)
    kw = dict(pigeon_clusters=2) if shape.startswith("pigeon") else {}
    if shape == "pigeon_plus":
        kw["optimizations"] = ("pigeon_plus",)
    name = "train_4k" if shape.startswith("pigeon") else shape
    spec = tsteps.input_specs(cfg, name, **kw)
    jcfg = jsteps.apply_shape_settings(jget_config(arch), JSHAPES[name])
    if name == "decode_32k":
        cache, tokens, index = spec.args
        jmodel = jax_build_model(jcfg)
        jtok, jidx, jcache, _ = jsteps.decode_structs(jcfg, jmodel, JSHAPES[name])
        assert tokens.shape == jtok.shape and index.shape == jidx.shape
        got = [t.shape for c in cache for t in c.values()]
        want = [x.shape for x in jax.tree.leaves(jcache)]
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))
        return
    want = [jsteps.batch_struct(jcfg, JSHAPES[name], cluster_dim=2 if kw else 0)]
    if kw:
        from dataclasses import replace
        want.append(jsteps.batch_struct(jcfg, replace(JSHAPES[name], global_batch=32)))
        if shape == "pigeon_plus":
            want.append(want[0])
    assert len(spec.args) == len(want)
    for got, w in zip(spec.args, want):
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}
        assert all(v.device.type == "meta" and v.dtype == torch.int32 for v in got.values())
    if shape == "pigeon":
        with pytest.raises(NotImplementedError, match="multi-card slice"):
            tsteps.input_specs(cfg, name, optimizations=("pigeon_shardmap",), **kw)
