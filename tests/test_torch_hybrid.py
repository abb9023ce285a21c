"""Parity of the port's Zamba2 hybrid (``arch_type="hybrid"``: ``mamba``
stacks with a ``shared_attn`` block between them) with the JAX reference on
the CPU.

Zamba2-1.2B's plan and its 1,204,036,480 parameters (the reference's
layers: each of the six shared-attention invocations holds its own), the
published cut at 10 (the client: Mamba2 6, the shared block, Mamba2 3);
``reduce_config(zamba2, n_layers=5)`` (Mamba2 2, shared, 2, shared, 1):
the loss and every gradient, the logits, the prefill step, the serve loop,
the split past a shared block, ``convert``'s round trips (the shared
block's leaves have no layer axis), the cluster-stacked model slot by slot
bit-equal to its plain model; ``run_pigeon`` over ``from_lm`` of a tiny
Zamba2 (a shared block on the client's side) on both engines against the
reference's batched runs (honest, label flip, int8 under
``loss_plus_distance``: ``selected``, ``detections``, ``accepted`` and
``comm`` equal, validation losses within rtol 1e-4); ``input_specs``'s
decode structs; the entry points on the CPU."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import configs as jconfigs
from repro.data import build_lm_task as jax_build_lm_task
from repro.launch import steps as jsteps
from repro.launch.shapes import SHAPES as JSHAPES
from repro.models import build_model as jax_build_model
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import reduce_config as jreduce
import repro_torch.core as tcore
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_split_from_reference,
                                 lm_split_to_reference, lm_to_reference)
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, ModelConfig, build_model, build_plan, build_stacked_model
from repro_torch.models.config import reduce_config
from _torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
ROUND_RTOL = 1e-4
B, S, PROMPT, NEW = 2, 16, 8, 6
ARCH = "zamba2-1.2b"
ZAMBA2_PARAMS = 1_204_036_480


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_zamba2_plan_parameters_and_published_cut():
    cfg = tconfigs.get_config(ARCH)
    model = Model(cfg, build_plan(cfg), "meta")
    assert [(sp.kind, sp.n) for sp in model.plan] == \
        [("mamba", 6), ("shared_attn", 1)] * 6 + [("mamba", 2)]
    jshape = jax.eval_shape(jax_build_model(jconfigs.get_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == ZAMBA2_PARAMS == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshape))
    client, ap, _ = model.split_plans()
    assert [(p.kind, p.n) for p in client] == [("mamba", 6), ("shared_attn", 1), ("mamba", 3)]
    assert [(p.kind, p.n) for p in ap][:3] == [("mamba", 3), ("shared_attn", 1), ("mamba", 6)]
    gamma, phi = model.split_params()
    assert [s.n for s in gamma.stacks] == [6, 1, 3]
    assert sum(s.n for s in phi.stacks if s.kind == "mamba") == 29
    assert sum(s.kind == "shared_attn" for s in phi.stacks) == 5


@pytest.fixture(scope="module")
def pair():
    cfg = jreduce(jconfigs.get_config(ARCH), n_layers=5)
    cfg = dataclasses.replace(cfg, cut_layer=3)
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(ModelConfig(**dataclasses.asdict(cfg)), _np_tree(params))
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    return jmodel, params, tmodel, jb, tb


def test_loss_gradients_and_logits_match_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    assert [(sp.kind, sp.n) for sp in tmodel.plan] == [
        ("mamba", 2), ("shared_attn", 1), ("mamba", 2), ("shared_attn", 1), ("mamba", 1)]
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(params, jb)
    tl, _ = tmodel.loss(tb)
    _close(float(tl.detach()), float(jl))
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    gmodel = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
        for a, b in zip(jax.tree.leaves(lm_to_reference(gmodel)), jax.tree.leaves(_np_tree(jg))):
            _close(a, b)
        _close(tmodel.logits(tb), jmodel.logits(params, jb), atol=1e-4)


def test_prefill_and_serve_loop_match_reference(pair):
    """The prefill step, and the serve loop: the shared blocks' KV caches
    (no layer axis) and the Mamba2 layers' state and convolution inputs."""
    jmodel, params, tmodel, jb, tb = pair
    _close(tsteps.make_prefill_step(tmodel)(tb), jsteps.make_prefill_step(jmodel)(params, jb),
           atol=1e-4)
    cache = tmodel.init_cache(B, PROMPT + NEW)
    jcache = jmodel.init_cache(B, PROMPT + NEW)
    assert [sorted((k, tuple(v.shape)) for k, v in c.items()) for c in cache] == \
        [sorted((k, tuple(v.shape)) for k, v in c.items()) for c in jcache]
    prompts = np.asarray(jb["tokens"])[:, :PROMPT]
    step = jax.jit(jmodel.decode_step)
    logits = None
    for i in range(PROMPT):
        logits, jcache = step(params, jcache, jnp.asarray(prompts[:, i:i + 1]), i)
    want_logits, want = np.asarray(logits), []
    for j in range(NEW):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, jcache = step(params, jcache, tok, PROMPT + j)
    got, got_logits = tserve.greedy_decode(tsteps.make_serve_step(tmodel), cache,
                                           torch.from_numpy(prompts.copy()).long(), NEW)
    _close(got_logits, want_logits, atol=1e-4)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_split_past_a_shared_block_matches_reference(pair):
    """cut_layer 3: the client holds Mamba2 2 and the first shared block
    (a block counts one layer toward the cut), the AP the rest."""
    jmodel, params, tmodel, jb, tb = pair
    client, ap, _ = tmodel.split_plans()
    assert [(p.kind, p.n) for p in client] == [("mamba", 2), ("shared_attn", 1)]
    assert [(p.kind, p.n) for p in ap] == [("mamba", 2), ("shared_attn", 1), ("mamba", 1)]
    jg, jp = jmodel.split_params(params)
    jacts = jmodel.client_forward(jg, jb)
    g, p = tmodel.split_params()
    with torch.no_grad():
        acts = tmodel.client_forward(g, tb)
        loss, _ = tmodel.ap_forward(p, acts, tb)
    _close(acts, jacts)
    _close(float(loss), float(jmodel.ap_forward(jp, jacts, jb)[0]))
    g2, p2 = lm_split_from_reference(tmodel.cfg, _np_tree(jg), _np_tree(jp))
    for a, b in zip(jax.tree.leaves(lm_split_to_reference(tmodel, g2, p2)),
                    jax.tree.leaves(_np_tree((jg, jp)))):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip_is_exact(pair):
    """Exact both ways; a shared block's leaves carry no layer axis."""
    _, params, tmodel, _, _ = pair
    back, want = lm_to_reference(tmodel), _np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    assert back["stacks"][1]["attn"]["wq"]["w"].shape == want["stacks"][1]["attn"]["wq"]["w"].shape
    assert back["stacks"][1]["attn"]["wq"]["w"].ndim == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_stacked_zamba2_slot_is_bit_equal_to_its_plain_model():
    cfg = dataclasses.replace(reduce_config(tconfigs.get_config(ARCH), n_layers=3), cut_layer=3)
    models = [build_model(cfg, "cpu").init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    stacked = build_stacked_model(cfg, 2, device="cpu")
    assert [s.kind for s in stacked.stacks] == ["mamba", "shared_attn", "mamba"]
    for r, m in enumerate(models):
        stacked.load_slot(r, m)
    rng = np.random.default_rng(22)
    batches = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S))),
               "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S)))}
    losses = stacked.loss(batches)
    grads = torch.autograd.grad(losses.sum(), list(stacked.parameters()))
    for r, m in enumerate(models):
        loss, _ = m.loss({k: v[r] for k, v in batches.items()})
        assert torch.equal(losses[r], loss), r
        for got, want in zip(grads, torch.autograd.grad(loss, list(m.parameters()))):
            assert torch.equal(got[r], want), r


# ---------------------------------------------------------------------------
# the round over a tiny Zamba2
# ---------------------------------------------------------------------------

TINY = dict(name="tiny-zamba2", arch_type="hybrid", n_layers=3, d_model=32, n_heads=2,
            n_kv_heads=2, head_dim=16, d_ff=0, vocab=64, ssm_state=8, attn_every=2,
            cut_layer=3)
TINY_TASK = dict(vocab=64, seq_len=16, m_clients=2, d_m=32, d_o=16, n_test=16, seed=0)
TINY_PCFG = dict(M=2, N=1, T=2, E=2, B=8, lr=5e-2, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest", "comm")
ROUND_CASES = {"honest": dict(),
               "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
               "stats_int8": dict(malicious={1}, attack=jcore.LABEL_FLIP,
                                  selection="loss_plus_distance", quant="int8")}


@pytest.fixture(scope="module")
def zamba2_round():
    jmodule = jcore.from_lm(jax_build_model(JModelConfig(**TINY)))
    pcfg = jcore.ProtocolConfig(**TINY_PCFG)
    _, k0 = jax.random.split(jax.random.PRNGKey(pcfg.seed))     # run_pigeon's init key
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(ModelConfig(**TINY), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(ModelConfig(**TINY), "cpu")),
                                  init=lambda _g: copy.deepcopy(theta))
    return dict(jmodule=jmodule, jdata=jax_build_lm_task(**TINY_TASK), jpcfg=pcfg,
                tmodule=tmodule, data=build_lm_task(**TINY_TASK),
                pcfg=tcore.ProtocolConfig(**TINY_PCFG))


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_run_pigeon_over_a_tiny_zamba2_matches_reference(case, zamba2_round):
    kw = dict(ROUND_CASES[case])
    kind = kw.pop("attack", jcore.NONE)
    want = jcore.run_pigeon(zamba2_round["jmodule"], zamba2_round["jdata"],
                            zamba2_round["jpcfg"], attack=jcore.Attack(kind), engine="batched",
                            **kw)
    for engine in ("batched", "sequential"):
        got = tcore.run_pigeon(zamba2_round["tmodule"], zamba2_round["data"],
                               zamba2_round["pcfg"], attack=tcore.Attack(kind), engine=engine,
                               device="cpu", **kw)
        assert len(got.rounds) == len(want.rounds)
        for rg, rw in zip(got.rounds, want.rounds):
            for k in DISCRETE:
                assert rg[k] == rw[k], (case, engine, rw["round"], k)
            np.testing.assert_allclose(rg["val_losses"], rw["val_losses"], rtol=ROUND_RTOL)


def test_input_specs_decode_structs_match_reference():
    """The decode step's arguments: the shared blocks' caches without a
    layer axis, the Mamba2 layers' state (f32) and convolution inputs; no
    memory (the reference's fourth value is None)."""
    cfg = tconfigs.get_config(ARCH)
    spec = tsteps.input_specs(cfg, "decode_32k")
    assert len(spec.args) == 3
    cache, tokens, index = spec.args
    jcfg = jsteps.apply_shape_settings(jconfigs.get_config(ARCH), JSHAPES["decode_32k"])
    jtok, jidx, jcache, jmem = jsteps.decode_structs(jcfg, jax_build_model(jcfg),
                                                     JSHAPES["decode_32k"])
    assert jmem is None and tokens.shape == jtok.shape and index.shape == jidx.shape
    assert [sorted((k, tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in c.items())
            for c in cache] == \
        [sorted((k, tuple(v.shape), str(v.dtype)) for k, v in c.items()) for c in jcache]
    assert tsteps.decode_structs(cfg, spec.model, tsteps.SHAPES["decode_32k"])[3] is None


def test_entry_points_run_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                 "--new-tokens", "2"])
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--protocol", "pigeon", "--engine",
                 "batched", "--rounds", "1", "--local-steps", "1", "--clients", "2",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "done: pigeon rounds=1" in out
