"""Parity of the port's vlm (``arch_type="vlm"``: the dense stack behind a
patch prefix, InternVL2-26B's ``reduce_config``: 2 layers, d_model 256, 8
patch embeddings) with the JAX reference on the CPU.

The patches (B, P, d_model), drawn from a seed as the reference's
``input_specs`` stubs the vision tower, lead the scaled token embeddings
(cast, not scaled); rope positions run over the prefixed sequence; the
loss and the AP's loss drop the P prefix positions.  Checked against the
reference: the loss and every gradient (f32 atol 1e-5), the logits and the
prefill step's last-position logits (atol 1e-4), the split halves with the
prefix, one train step (plain and over the int8 wire: loss and every
updated parameter within atol 1e-6), the serve loop on text tokens (decode
logits atol 2e-4, greedy tokens equal), ``convert``'s round trips, the
cluster-stacked vlm slot by slot bit-equal to its plain model (tokens
only, as the LM round takes it), ``run_pigeon`` over ``from_lm`` of a tiny
vlm on both engines against the reference's batched run (label flip:
discrete outcomes equal), ``input_specs`` on the meta device, and the
entry points."""
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
import repro_torch.core as tcore
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_split_from_reference,
                                 lm_split_to_reference, lm_to_reference)
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import ModelConfig, build_model, build_stacked_model
from _torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
FORWARD_ATOL = 1e-4
DECODE_ATOL = 2e-4
PARAM_ATOL = 1e-6
ROUND_RTOL = 1e-4
LR = 0.05
B, S, PROMPT, NEW = 2, 16, 8, 6
ARCH = "internvl2-26b"


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(jax model, params, port model, reference batch, port batch): the
    reference's init carried across; tokens, labels and patches from a
    seed."""
    cfg = jconfigs.get_smoke_config(ARCH)
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(ModelConfig(**dataclasses.asdict(cfg)), _np_tree(params))
    rng = np.random.default_rng(13)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    patches = rng.normal(size=(B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "patches": jnp.asarray(patches)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
          "patches": torch.from_numpy(patches)}
    return jmodel, params, tmodel, jb, tb


def test_config_plan_and_param_count():
    cfg = tconfigs.get_config(ARCH)
    assert cfg.arch_type == "vlm" and cfg.n_prefix_tokens == 256
    assert cfg.param_count() == jconfigs.get_config(ARCH).param_count() == 19_860_664_320
    model = build_model(tconfigs.get_smoke_config(ARCH), "cpu")
    assert [(sp.kind, sp.n) for sp in model.plan] == [("attn_mlp", 2)]


def test_loss_gradients_and_logits_match_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    (jl, jmet), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb)
    tl, tmet = tmodel.loss(tb)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL)
    assert float(tmet["aux_loss"]) == 0.0
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    gmodel = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
        for a, b in zip(jax.tree.leaves(lm_to_reference(gmodel)),
                        jax.tree.leaves(_np_tree(jg))):
            np.testing.assert_allclose(a, b, atol=ATOL)
        logits = tmodel.logits(tb)
        assert logits.shape[1] == tb["patches"].shape[1] + S
        np.testing.assert_allclose(logits.numpy(), np.asarray(jmodel.logits(params, jb)),
                                   atol=FORWARD_ATOL)
        # without patches the vlm is the dense LM over the tokens
        text = {k: v for k, v in tb.items() if k != "patches"}
        jtext = {k: v for k, v in jb.items() if k != "patches"}
        np.testing.assert_allclose(float(tmodel.loss(text)[0]),
                                   float(jmodel.loss(params, jtext)[0]), atol=ATOL)


def test_prefill_step_matches_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    want = jsteps.make_prefill_step(jmodel)(params, jb)
    got = tsteps.make_prefill_step(tmodel)(tb)
    assert got.shape == (B, 1, tmodel.cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FORWARD_ATOL)


def test_split_halves_match_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    jg, jp = jmodel.split_params(params)
    jacts = jmodel.client_forward(jg, jb)
    jl, _ = jmodel.ap_forward(jp, jacts, jb)
    g, p = tmodel.split_params()
    with torch.no_grad():
        acts = tmodel.client_forward(g, tb)
        tl, _ = tmodel.ap_forward(p, acts, tb)
    assert acts.shape == (B, tb["patches"].shape[1] + S, tmodel.cfg.d_model)
    np.testing.assert_allclose(acts.numpy(), np.asarray(jacts), atol=FORWARD_ATOL)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    g2, p2 = lm_split_from_reference(tmodel.cfg, _np_tree(jg), _np_tree(jp))
    for a, b in zip(jax.tree.leaves(lm_split_to_reference(tmodel, g2, p2)),
                    jax.tree.leaves(_np_tree((jg, jp)))):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip_is_exact(pair):
    _, params, tmodel, _, _ = pair
    back, want = lm_to_reference(tmodel), _np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_train_step_with_patches_matches_reference(pair, quant):
    """One SGD step over a batch with patches (the int8 wire between the
    halves, the patches' activations included): the loss and every updated
    parameter."""
    jmodel, params, tmodel, jb, tb = pair
    new_params, jl = jax.jit(jsteps.make_train_step(jmodel, LR, quant=quant))(params, jb)
    model = copy.deepcopy(tmodel)
    tl = tsteps.make_train_step(model, LR, quant=quant)(tb)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    for a, b in zip(jax.tree.leaves(lm_to_reference(model)),
                    jax.tree.leaves(_np_tree(new_params))):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL)


def test_serve_loop_on_text_matches_reference(pair):
    """The serve loop steps text tokens only (the reference's): decode
    logits at the prompt's last position and the greedy tokens."""
    jmodel, params, tmodel, jb, tb = pair
    prompts = np.asarray(jb["tokens"])[:, :PROMPT]
    step = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(B, PROMPT + NEW)
    for i in range(PROMPT):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]), i)
    want_logits, want = np.asarray(logits), []
    for j in range(NEW):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, PROMPT + j)
    got, got_logits = tserve.greedy_decode(tsteps.make_serve_step(tmodel),
                                           tmodel.init_cache(B, PROMPT + NEW),
                                           torch.from_numpy(prompts.copy()).long(), NEW)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, atol=DECODE_ATOL)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_stacked_vlm_slot_is_bit_equal_to_its_plain_model():
    """The cluster-stacked vlm takes tokens only (the reference's LM round
    passes ``{"tokens": ...}``): slot r is its plain model's dense forward,
    loss and gradients, bit for bit."""
    cfg = tconfigs.get_smoke_config(ARCH)
    models = [build_model(cfg, "cpu").init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    stacked = build_stacked_model(cfg, 2, device="cpu")
    for r, m in enumerate(models):
        stacked.load_slot(r, m)
    rng = np.random.default_rng(14)
    batches = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S))),
               "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S)))}
    losses = stacked.loss(batches)
    grads = torch.autograd.grad(losses.sum(), list(stacked.parameters()))
    for r, m in enumerate(models):
        loss, _ = m.loss({k: v[r] for k, v in batches.items()})
        assert torch.equal(losses[r], loss), r
        for got, want in zip(grads, torch.autograd.grad(loss, list(m.parameters()))):
            assert torch.equal(got[r], want), r


TINY = dict(name="tiny-vlm", arch_type="vlm", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=64, n_prefix_tokens=4, cut_layer=1)
TINY_TASK = dict(vocab=64, seq_len=16, m_clients=2, d_m=32, d_o=16, n_test=16, seed=0)
TINY_PCFG = dict(M=2, N=1, T=2, E=2, B=8, lr=5e-2, seed=0)


def test_run_pigeon_over_a_tiny_vlm_matches_reference():
    """The LM round over a vlm is the dense round (tokens only, as the
    reference's ``from_lm`` passes them), on both engines."""
    jmodule = jcore.from_lm(jax_build_model(JModelConfig(**TINY)))
    pcfg = jcore.ProtocolConfig(**TINY_PCFG)
    _, k0 = jax.random.split(jax.random.PRNGKey(pcfg.seed))
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(ModelConfig(**TINY), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(ModelConfig(**TINY), "cpu")),
                                  init=lambda _g: copy.deepcopy(theta))
    want = jcore.run_pigeon(jmodule, jax_build_lm_task(**TINY_TASK), pcfg, malicious={1},
                            attack=jcore.Attack(jcore.LABEL_FLIP), engine="batched")
    for engine in ("batched", "sequential"):
        got = tcore.run_pigeon(tmodule, build_lm_task(**TINY_TASK),
                               tcore.ProtocolConfig(**TINY_PCFG), malicious={1},
                               attack=tcore.Attack(tcore.LABEL_FLIP), engine=engine, device="cpu")
        for rg, rw in zip(got.rounds, want.rounds):
            for k in ("clusters", "selected", "accepted", "detections", "comm"):
                assert rg[k] == rw[k], (engine, k)
            np.testing.assert_allclose(rg["val_losses"], rw["val_losses"], rtol=ROUND_RTOL)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "pigeon"])
def test_input_specs_give_the_reference_shapes(shape):
    cfg = tconfigs.get_config(ARCH)
    kw = dict(pigeon_clusters=2) if shape == "pigeon" else {}
    name = "train_4k" if shape == "pigeon" else shape
    spec = tsteps.input_specs(cfg, name, **kw)
    jcfg = jsteps.apply_shape_settings(jconfigs.get_config(ARCH), JSHAPES[name])
    if name == "decode_32k":
        cache, tokens, index = spec.args
        jtok, jidx, jcache, _ = jsteps.decode_structs(jcfg, jax_build_model(jcfg),
                                                      JSHAPES[name])
        assert tokens.shape == jtok.shape and index.shape == jidx.shape
        got = sorted(tuple(t.shape) for c in cache for t in c.values())
        assert got == sorted(tuple(x.shape) for x in jax.tree.leaves(jcache))
        return
    want = jsteps.batch_struct(jcfg, JSHAPES[name], cluster_dim=2 if kw else 0)
    got = spec.args[0]
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["patches"].dtype == torch.bfloat16 and got["tokens"].dtype == torch.int32
    assert all(p.device.type == "meta" for p in spec.model.parameters())


def test_entry_points_run_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                 "--new-tokens", "2"])
    ttrain.main(["--arch", ARCH, "--device", "cpu", "--protocol", "pigeon", "--rounds", "1",
                 "--local-steps", "1", "--clients", "2", "--batch", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and "done: pigeon rounds=1" in out
