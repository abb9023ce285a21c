"""Parity of the port's dense-LM training path with the JAX reference on the
CPU: ``Model.loss`` and every parameter's gradient, the split view
(``split_params``/``merge_params``, ``client_forward``/``ap_forward``),
``make_train_step`` with and without the int8 wire, the straight-through
wire itself, and the Pigeon-SL round over ``from_lm`` on the fixture of
``tests/test_system.py::test_e2e_protocol_over_transformer_lm`` (also with
the int8 wire under ``loss_plus_distance``); remat on
and off; the train CLI.

Tolerances, f32 throughout: loss, gradients and the train step's new
parameters atol 1e-5; cut activations atol 1e-4 (``tests/test_torch_lm.py``'s
forward bound); the round's discrete outcomes equal and its losses and test
accuracy within 1e-4.  The reference computes its loss through the plain
cross-entropy (full or chunked logits), the port through B4's plain
version: the same function."""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import configs as jconfigs
from repro.data import build_lm_task as jax_build_lm_task
from repro.kernels import ops as jops
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
from repro.models.config import ModelConfig as JModelConfig
import repro_torch.core as tcore
from repro_torch.convert import (lm_from_reference, lm_split_from_reference,
                                 lm_split_to_reference, lm_to_reference)
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from _torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
ACTS_ATOL = 1e-4
ROUND_RTOL = 1e-4
B, S = 2, 16
LR = 0.05
# the fixture of tests/test_system.py::test_e2e_protocol_over_transformer_lm
TINY = dict(name="tiny-lm", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=64, cut_layer=1)
TINY_TASK = dict(vocab=64, seq_len=32, m_clients=2, d_m=64, d_o=32, n_test=32, seed=0)
TINY_PCFG = dict(M=2, N=1, T=2, E=3, B=8, lr=5e-2, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")


def _qwen(**changes):
    """qwen3-8b at reduce_config size with 2 KV heads (GQA) and qkv bias."""
    return dataclasses.replace(jconfigs.get_smoke_config("qwen3-8b"), n_kv_heads=2,
                               qkv_bias=True, **changes)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _pair(cfg, seed=0):
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(seed))
    return jmodel, params, lm_from_reference(_port_cfg(cfg), _np_tree(params))


def _batch(cfg, mask=False, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    if mask:
        batch["mask"] = (rng.random((B, S)) > 0.3).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _grad_tree(model, grads):
    """A gradient list in ``model.parameters()`` order as the reference's
    parameter pytree."""
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    return lm_to_reference(holder)


def _assert_trees_close(got, want, atol, what):
    assert jax.tree.structure(got) == jax.tree.structure(_np_tree(want)), what
    for path_leaf, w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        path, g = path_leaf
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


LOSS_CASES = {"plain": dict(), "masked": dict(mask=True),
              "chunked_masked": dict(mask=True, loss_chunk=8)}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_every_gradient_match_reference(case):
    """The reference's branches: full logits, masked, and (loss_chunk <
    S) its scanned chunks; the port computes each through one B4 call."""
    kw = dict(LOSS_CASES[case])
    mask = kw.pop("mask", False)
    jmodel, params, tmodel = _pair(_qwen(**kw))
    jb, tb = _batch(jmodel.cfg, mask)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb)
    tloss, tmetrics = tmodel.loss(tb)
    grads = torch.autograd.grad(tloss, list(tmodel.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=ATOL)
    np.testing.assert_allclose(float(tmetrics["lm_loss"].detach()),
                               float(jmetrics["lm_loss"]), atol=ATOL)
    assert float(tmetrics["aux_loss"]) == float(jmetrics["aux_loss"]) == 0.0
    _assert_trees_close(_grad_tree(tmodel, grads), jgrads, ATOL, case)


@pytest.mark.parametrize("cut", [0, 1, 2])
def test_split_view_round_trips_and_matches_reference(cut):
    jmodel, params, tmodel = _pair(_qwen(cut_layer=cut))
    jb, tb = _batch(jmodel.cfg)
    jg, jp = jmodel.split_params(params)
    tg, tp = lm_split_from_reference(tmodel.cfg, _np_tree(jg), _np_tree(jp))
    # the reference's split pytrees -> the port's halves -> back, exactly
    back_g, back_p = lm_split_to_reference(tmodel, tg, tp)
    for got, want in ((back_g, jg), (back_p, jp)):
        assert jax.tree.structure(got) == jax.tree.structure(_np_tree(want))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    # the port's own split shares the model's parameters and merges back
    g, p = tmodel.split_params()
    merged = tmodel.merge_params(g, p)
    assert [id(x) for x in merged.parameters()] == [id(x) for x in tmodel.parameters()]
    assert (sum(x.numel() for x in g.parameters()) + sum(x.numel() for x in p.parameters())
            == sum(x.numel() for x in tmodel.parameters()))
    jacts = jmodel.client_forward(jg, jb)
    tacts = tmodel.client_forward(tg, tb)
    np.testing.assert_allclose(tacts.detach().numpy(), np.asarray(jacts), atol=ACTS_ATOL)
    jl, _ = jmodel.ap_forward(jp, jacts, jb)
    tl, _ = tmodel.ap_forward(tp, torch.from_numpy(np.array(jacts)), tb)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_train_step_matches_reference(quant):
    jmodel, params, tmodel = _pair(_qwen())
    jb, tb = _batch(jmodel.cfg, mask=True)
    new_params, jloss = jax.jit(jax_make_train_step(jmodel, LR, quant))(params, jb)
    step = make_train_step(tmodel, LR, quant)
    tloss = step(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=ATOL)
    _assert_trees_close(lm_to_reference(tmodel), new_params, ATOL, f"quant={quant}")
    second = step(tb)                     # the step keeps working on its updated model
    assert float(second) < float(tloss)


def test_quant_cut_exchange_matches_reference_both_ways():
    """The straight-through wire: forward = per-sample int8 round trip of
    the activations, backward = the same of the cut gradient, bit-equal to
    the reference's custom_vjp; ``None`` is the identity."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    g = rng.normal(size=(3, 5, 8)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a: jops.quant_cut_exchange(a, "int8"), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tops.quant_cut_exchange(tx, "int8")
    (tg,) = torch.autograd.grad(ty, tx, grad_outputs=torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tops.quant_cut_exchange(tx, None) is tx
    with pytest.raises(ValueError, match="quant format"):
        tops.quant_cut_exchange(tx, "int4")


def test_remat_on_and_off_give_the_same_bits():
    """Checkpointed layers recompute the same values: the loss, every
    gradient, and the client backward from a received cut gradient."""
    cfg = _port_cfg(_qwen(n_layers=3, cut_layer=2))
    base = build_model(cfg, "cpu").init(torch.Generator().manual_seed(3))
    _, tb = _batch(cfg)
    out = {}
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss, _ = model.loss(tb)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        gamma, _ = model.split_params()
        acts = model.client_forward(gamma, tb)
        g_recv = torch.from_numpy(np.random.default_rng(4).normal(
            size=tuple(acts.shape)).astype(np.float32))
        g_gamma = torch.autograd.grad(acts, list(gamma.parameters()), grad_outputs=g_recv)
        out[remat] = (loss.detach(), grads, acts.detach(), g_gamma)
    (l0, g0, a0, c0), (l1, g1, a1, c1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for x, y in zip(list(g0) + list(c0), list(g1) + list(c1)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def lm_round():
    """The reference's task and split module for the fixture, and the port's
    module carrying the reference's initial (gamma, phi) for its seed."""
    cfg = JModelConfig(**TINY)
    jmodule = jcore.from_lm(jax_build_model(cfg))
    jdata = jax_build_lm_task(**TINY_TASK)
    pcfg = jcore.ProtocolConfig(**TINY_PCFG)
    _, k0 = jax.random.split(jax.random.PRNGKey(pcfg.seed))   # run_pigeon's init key
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(_port_cfg(cfg), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(_port_cfg(cfg), "cpu")),
                                  init=lambda _g: theta)
    return jmodule, jdata, pcfg, tmodule, build_lm_task(**TINY_TASK), \
        tcore.ProtocolConfig(**TINY_PCFG)


def test_lm_task_arrays_bit_equal(lm_round):
    _, jdata, _, _, data, _ = lm_round
    for name in ("x", "y", "x0", "y0", "x_test", "y_test"):
        a, b = getattr(data, name), getattr(jdata, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# "stats_int8": the int8 wire under a policy that scores the transmitted
# messages' statistics (B3 on every client step's uplink)
ROUND_CASES = {"honest": dict(), "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
               "stats_int8": dict(malicious={1}, attack=jcore.LABEL_FLIP,
                                  selection="loss_plus_distance", quant="int8")}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_run_pigeon_over_from_lm_matches_reference(case, lm_round):
    jmodule, jdata, jpcfg, tmodule, data, pcfg = lm_round
    kw = dict(ROUND_CASES[case])
    kind = kw.pop("attack", jcore.NONE)
    hj = jcore.run_pigeon(jmodule, jdata, jpcfg, attack=jcore.Attack(kind), **kw)
    ht = tcore.run_pigeon(tmodule, data, pcfg, attack=tcore.Attack(kind), device="cpu",
                          **kw)
    assert len(hj.rounds) == len(ht.rounds) == pcfg.T
    for rj, rt in zip(hj.rounds, ht.rounds):
        for k in DISCRETE:
            assert rt[k] == rj[k], (case, rj["round"], k)
        for k in ("val_losses", "train_losses", "test_acc"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=ROUND_RTOL, atol=0,
                                       err_msg=f"{case} round {rj['round']} {k}")


def test_from_lm_draws_one_init_from_one_seed():
    cfg = _port_cfg(JModelConfig(**TINY))
    module = tcore.from_lm(build_model(cfg, "cpu"))
    a = [p.detach().clone() for half in module.init(torch.Generator().manual_seed(5))
         for p in half.parameters()]
    b = [p.detach().clone() for half in module.init(torch.Generator().manual_seed(5))
         for p in half.parameters()]
    assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_cli_on_the_cpu(capsys):
    ttrain.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--rounds", "1",
                 "--local-steps", "2", "--batch", "4", "--attack", "label_flip",
                 "--malicious", "1"])
    out = capsys.readouterr().out
    assert "round 0: selected=" in out and "done: pigeon+ rounds=1" in out and "(CPU)" in out


@pytest.mark.parametrize("flags,want", [
    (["--protocol", "vanilla"], "round 1: train_loss="),
    (["--protocol", "sfl"], "round 1: selected="),
    (["--protocol", "sfl", "--engine", "batched"], "round 1: selected="),
    (["--protocol", "vanilla", "--arch", "qwen3-8b", "--smoke", "--batch", "4"],
     "round 1: train_loss="),
    (["--protocol", "sfl", "--engine", "batched", "--arch", "qwen3-8b", "--smoke",
      "--batch", "4"], "round 1: selected="),
    (["--protocol", "pigeon+", "--engine", "batched", "--arch", "qwen3-8b", "--smoke",
      "--batch", "4"], "round 1: selected=")])
def test_train_cli_runs_the_baselines(flags, want, capsys):
    ttrain.main(["--device", "cpu", "--rounds", "2", "--local-steps", "2",
                 "--attack", "label_flip", "--malicious", "1",
                 *(["--task", "mnist"] if "--arch" not in flags else []), *flags])
    out = capsys.readouterr().out
    assert want in out and f"done: {flags[1]} rounds=2" in out and "(CPU)" in out


@pytest.mark.parametrize("flags,match", [(["--compile-cache"], "done: pigeon+ rounds=1")])
def test_train_cli_names_what_is_not_ported(flags, match, tmp_path, monkeypatch, capsys):
    """No flag of the train CLI is left unported: ``--compile-cache DIR``,
    the last that raised, runs (``tests/test_torch_compile_cache.py`` holds
    what it does to the kernel libraries' directory)."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tbuild.BUILD_DIR)
    ttrain.main(["--device", "cpu", "--task", "mnist", "--rounds", "1", "--local-steps", "1",
                 *flags, str(tmp_path / "cache")])
    assert match in capsys.readouterr().out
    assert not hasattr(ttrain, "NOT_PORTED")


@pytest.mark.parametrize("flag", ["--trace", "--profile-dir", "--block"])
def test_train_cli_runs_trace_profile_and_block(flag, tmp_path, capsys):
    """--trace writes a JSONL trace, --profile-dir a profiler trace of round
    1, --block 2 runs two-round blocks on the batched engine (pigeon; the
    default pigeon+ forces 1)."""
    from repro_torch.telemetry import read_jsonl
    value = {"--trace": str(tmp_path / "t.jsonl"), "--profile-dir": str(tmp_path / "p"),
             "--block": "2"}[flag]
    ttrain.main(["--device", "cpu", "--task", "mnist", "--rounds", "3", "--local-steps",
                 "2", "--protocol", "pigeon", flag, value])
    out = capsys.readouterr().out
    assert "done: pigeon rounds=3" in out and "round 2: selected=" in out
    if flag == "--trace":
        events = read_jsonl(value)
        assert [e["t"] for e in events if e["event"] == "round"] == [0, 1, 2]
        assert events[0]["provenance"]["torch"] == torch.__version__
    elif flag == "--profile-dir":
        assert os.listdir(value) == ["trace_1_2.json"]
