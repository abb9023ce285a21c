"""The Pigeon-SL round over an xLSTM: the cluster-stacked xLSTM
(``models.StackedModel`` of an xLSTM plan: ``StackedMixerBlock``,
``StackedMLSTM``, ``StackedSLSTM``) slot by slot against the plain model,
its conversion to and from the reference's parameter trees, ``run_pigeon``
over ``from_lm`` of a tiny xLSTM on both engines against the reference's
runs, and ``input_specs`` of the xLSTM round.

The tiny xLSTM has d_model 32, 2 heads and one (mLSTM, sLSTM) pair a side of
the cut (4 blocks, cut 2), chunk 16 over sequences of 32 (two chunks).
Tolerances, f32 throughout: a slot of the stacked model is bit-equal to its
plain model on the CPU (the products and the sLSTM's scan run one a slot,
the mLSTM's chunked einsums over the folded slot axis round alike); the
rounds' discrete outcomes equal the reference's, their losses and test
accuracy within rtol 1e-4 (``tests/test_torch_lm_round.py``'s bound), and
the port's two engines take equal decisions.  The reference's runs are
computed once for the module."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.data import build_lm_task as jax_build_lm_task
from repro.launch import steps as jsteps
from repro.launch.shapes import SHAPES as JSHAPES
from repro.models import build_model as jax_build_model
from repro.models.config import ModelConfig as JModelConfig
import repro_torch.core as tcore
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_slot_to_reference,
                                 lm_split_from_reference, lm_stack_from_reference,
                                 lm_to_reference)
from repro_torch.core.runner import broadcast_winner
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.launch import steps as tsteps
from repro_torch.models import ModelConfig, build_model, build_stacked_model
from _torch_threads import one_thread  # noqa: F401

ROUND_RTOL = 1e-4
TINY = dict(name="tiny-xlstm", arch_type="ssm", n_layers=4, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=0, vocab=64, slstm_every=2, ssm_chunk=16, cut_layer=2)
TINY_TASK = dict(vocab=64, seq_len=32, m_clients=2, d_m=32, d_o=16, n_test=16, seed=0)
TINY_PCFG = dict(M=2, N=1, T=2, E=2, B=8, lr=5e-2, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")
FLOATS = ("val_losses", "train_losses", "test_acc")


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the stacked xLSTM, slot by slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_stacked_xlstm_slot_is_bit_equal_to_its_plain_model(remat):
    """Slot r of ``StackedModel.loss``, ``client_forward`` and both
    gradients (the loss's w.r.t. every parameter, the cut activations' for a
    given cut gradient) equal the plain xLSTM of slot r's parameters, bit
    for bit, in the replica form (2 replicas of 2 slots)."""
    cfg = ModelConfig(**TINY, remat=remat)
    models = [build_model(cfg, "cpu").init(torch.Generator().manual_seed(s))
              for s in range(4)]
    stacked = build_stacked_model(cfg, 2, replicas=2, device="cpu")
    for r, m in enumerate(models):
        stacked.load_slot(r, m)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 64, (4, 2, 32)))
    batches = {"tokens": toks, "labels": torch.from_numpy(rng.integers(0, 64, (4, 2, 32)))}
    losses = stacked.loss(batches)
    grads = torch.autograd.grad(losses.sum(), list(stacked.parameters()))
    gamma, _ = stacked.split_params()
    acts = stacked.client_forward(gamma, toks)
    g_cut = torch.from_numpy(rng.normal(size=tuple(acts.shape)).astype(np.float32))
    g_acts = torch.autograd.grad(acts, list(gamma.parameters()), grad_outputs=g_cut)
    assert losses.shape == (4,) and acts.shape == (4, 2, 32, 32)
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


def test_stacked_xlstm_halves_follow_the_plain_halves_order():
    """The ``StackedSplit`` contract over an xLSTM: each stacked half's
    ``parameters()`` follow the plain half's names and shapes with the slot
    axis in front (r (n, H, dh, 4dh) among them)."""
    module = tcore.from_lm(build_model(ModelConfig(**TINY), "cpu"))
    plain = module.init(torch.Generator().manual_seed(0))
    stacked = module.stacked.make(3)
    for p_half, s_half in zip(plain, stacked):
        pn = [(n, tuple(p.shape)) for n, p in p_half.named_parameters()]
        sn = [(n, tuple(p.shape)[1:]) for n, p in s_half.named_parameters()]
        assert pn == sn
        assert all(p.shape[0] == 3 for p in s_half.parameters())
    assert any(n.endswith("mixer.r") for n, _ in stacked[0].named_parameters())
    assert any(n.endswith("mixer.r") for n, _ in stacked[1].named_parameters())


def test_xlstm_stack_conversion_round_trip():
    """``lm_stack_from_reference`` puts the reference's xLSTM tree r in slot
    r and ``lm_slot_to_reference`` takes it back exactly; a slot's plain
    model is the plain conversion of its tree; ``broadcast_winner`` copies
    one slot into every slot."""
    jm = jax_build_model(JModelConfig(**TINY))
    trees = [_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(s))) for s in (0, 1)]
    stacked = lm_stack_from_reference(ModelConfig(**TINY), trees)
    for r, tree in enumerate(trees):
        got = lm_slot_to_reference(stacked, r)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(stacked.slot_model(1).parameters(),
                    lm_from_reference(ModelConfig(**TINY), trees[1]).parameters()):
        assert torch.equal(a, b)
    broadcast_winner(stacked, torch.tensor(1))
    for a, b in zip(jax.tree.leaves(lm_to_reference(stacked.slot_model(0))),
                    jax.tree.leaves(trees[1])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# run_pigeon over from_lm of the tiny xLSTM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm_round():
    """The reference's task and split module, the port's module carrying
    the reference's initial (gamma, phi), and a cache of the reference's
    batched runs (one a case for the module)."""
    cfg = JModelConfig(**TINY)
    jmodule = jcore.from_lm(jax_build_model(cfg))
    pcfg = jcore.ProtocolConfig(**TINY_PCFG)
    _, k0 = jax.random.split(jax.random.PRNGKey(pcfg.seed))   # run_pigeon's init key
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(ModelConfig(**TINY), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(ModelConfig(**TINY), "cpu")),
                                  init=lambda _g: copy.deepcopy(theta))
    return dict(jmodule=jmodule, jdata=jax_build_lm_task(**TINY_TASK), jpcfg=pcfg,
                tmodule=tmodule, data=build_lm_task(**TINY_TASK),
                pcfg=tcore.ProtocolConfig(**TINY_PCFG), ref={})


# "stats_int8": the int8 wire under a policy that scores the transmitted
# messages' statistics
ROUND_CASES = {"honest": dict(),
               "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
               "stats_int8": dict(malicious={1}, attack=jcore.LABEL_FLIP,
                                  selection="loss_plus_distance", quant="int8"),
               "plus": dict(malicious={1}, attack=jcore.LABEL_FLIP, plus=True)}


def _reference(xlstm_round, case: str):
    if case not in xlstm_round["ref"]:
        kw = dict(ROUND_CASES[case])
        kind = kw.pop("attack", jcore.NONE)
        xlstm_round["ref"][case] = jcore.run_pigeon(
            xlstm_round["jmodule"], xlstm_round["jdata"], xlstm_round["jpcfg"],
            attack=jcore.Attack(kind), engine="batched", **kw)
    return xlstm_round["ref"][case]


def _port(xlstm_round, case: str, engine: str):
    kw = dict(ROUND_CASES[case])
    kind = kw.pop("attack", jcore.NONE)
    return tcore.run_pigeon(xlstm_round["tmodule"], xlstm_round["data"], xlstm_round["pcfg"],
                            attack=tcore.Attack(kind), engine=engine, device="cpu", **kw)


def _assert_matches(got, want, what, floats=True):
    assert len(got.rounds) == len(want.rounds)
    for rg, rw in zip(got.rounds, want.rounds):
        for k in DISCRETE:
            if k in rw:
                assert rg[k] == rw[k], (what, rw["round"], k)
        for k in FLOATS:
            if floats and k in rw:
                np.testing.assert_allclose(rg[k], rw[k], rtol=ROUND_RTOL, atol=0,
                                           err_msg=f"{what} round {rw['round']} {k}")


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_run_pigeon_over_xlstm_matches_reference_on_both_engines(case, xlstm_round):
    """Both of the port's engines against the reference's batched run:
    decisions exactly, floats within rtol 1e-4; the two engines' decisions
    equal and their validation losses within the same rtol."""
    want = _reference(xlstm_round, case)
    runs = {engine: _port(xlstm_round, case, engine) for engine in ("sequential", "batched")}
    for engine, hist in runs.items():
        _assert_matches(hist, want, f"{case} {engine}")
    _assert_matches(runs["batched"], runs["sequential"], f"{case} batched vs sequential",
                    floats=False)
    for rb, rs in zip(runs["batched"].rounds, runs["sequential"].rounds):
        np.testing.assert_allclose(rb["val_losses"], rs["val_losses"], rtol=ROUND_RTOL)


# ---------------------------------------------------------------------------
# the launch layer over a stacked xLSTM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["pigeon", "pigeon_plus"])
def test_input_specs_of_the_xlstm_round(shape):
    """``input_specs(xlstm-1.3b, train_4k, pigeon_clusters=2)``: the
    reference's batch and validation shapes, a 2-slot stacked xLSTM on the
    meta device (one r (2, H, dh, 4dh) a sLSTM block), and its step."""
    from repro.configs import get_config as jget_config
    kw = dict(pigeon_clusters=2)
    if shape == "pigeon_plus":
        kw["optimizations"] = ("pigeon_plus",)
    cfg = tconfigs.get_config("xlstm-1.3b")
    spec = tsteps.input_specs(cfg, "train_4k", **kw)
    jcfg = jsteps.apply_shape_settings(jget_config("xlstm-1.3b"), JSHAPES["train_4k"])
    want = [jsteps.batch_struct(jcfg, JSHAPES["train_4k"], cluster_dim=2),
            jsteps.batch_struct(jcfg, dataclasses.replace(JSHAPES["train_4k"],
                                                          global_batch=32))]
    if shape == "pigeon_plus":
        want.append(want[0])
    assert len(spec.args) == len(want)
    for got, w in zip(spec.args, want):
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}
    rs = [p for n, p in spec.model.named_parameters() if n.endswith("mixer.r")]
    dh = cfg.d_model // cfg.n_heads
    assert len(rs) == cfg.n_layers // cfg.slstm_every
    assert all(tuple(p.shape) == (2, cfg.n_heads, dh, 4 * dh) and p.device.type == "meta"
               for p in rs)
    assert callable(spec.fn)


def test_round_step_over_a_stacked_xlstm():
    """``make_pigeon_round_step`` on a 2-slot stacked tiny xLSTM: the
    argmin of the round's validation losses, the winner in every slot."""
    cfg = ModelConfig(**TINY)
    stacked = build_stacked_model(cfg, 2, device="cpu")
    for slot in range(2):
        stacked.load_slot(slot, build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(slot)))
    rng = np.random.default_rng(9)
    batches = {k: torch.from_numpy(rng.integers(0, 64, (2, 4, 32))) for k in ("tokens",
                                                                          "labels")}
    val = {k: torch.from_numpy(rng.integers(0, 64, (8, 32))) for k in ("tokens", "labels")}
    vlosses, sel = tsteps.make_pigeon_round_step(stacked, 0.05)(batches, val)
    assert vlosses.shape == (2,) and bool(torch.isfinite(vlosses).all())
    assert int(sel) == int(torch.argmin(vlosses))
    assert all(torch.equal(p[0], p[1]) for p in stacked.parameters())
