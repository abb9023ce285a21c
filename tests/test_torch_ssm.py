"""Parity of the port's Mamba2 (``models/ssm.py``) and of the Mamba2 stack
(``arch_type="ssm"`` without ``slstm_every``, the ``mamba`` kind) with the
JAX reference on the CPU.

The mixer: the chunked SSD forward against the reference's
``mamba2_forward`` (several chunks, the state carried across), each decode
step and its cache against ``mamba2_decode``, the chunked forward against
the port's own token-by-token oracle (the reference's
``test_mamba2_chunked_matches_recurrent`` pattern), the gradients against
``jax.grad`` (finite: the mask comes before ``exp``), and the chunk that
must divide the sequence.  The model (the reference's
``tests/test_models.py`` Mamba2 config): the loss and every gradient, the
logits, the prefill step, the serve loop, the split at a cut inside the
``mamba`` stack, ``convert``'s round trips (exact), the cache's dtypes, and
the cluster-stacked model slot by slot bit-equal to its plain model.
f32 values within rtol 1e-4 and atol 1e-5."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jsteps
from repro.models import build_model as jax_build_model
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.convert import (lm_from_reference, lm_split_from_reference,
                                 lm_split_to_reference, lm_to_reference)
from repro_torch.kernels import build as tbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import ModelConfig, build_model, build_stacked_model
from repro_torch.models import ssm as tssm
from _torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, S, PROMPT, NEW = 2, 16, 8, 6
MIXER = dict(d_model=32, d_state=8, chunk=4)
SSM = dict(name="mamba2-test", arch_type="ssm", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=4, d_ff=0, vocab=64, ssm_state=16, ssm_chunk=8, cut_layer=1)


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


@pytest.fixture(scope="module")
def mixer():
    """(reference params, the port's Mamba2 holding them, u (2, 16, 32))."""
    cfg = jssm.SSMConfig(**MIXER)
    params = jssm.mamba2_init(jax.random.PRNGKey(0), cfg)
    mod = tssm.Mamba2(tssm.SSMConfig(**MIXER))
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = params
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.from_numpy(np.array(leaf)))
    u = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32)) * 0.5)
    return params, mod, u


def test_mixer_parameters_mirror_mamba2_init(mixer):
    params, mod, _ = mixer
    names = sorted(n for n, _ in mod.named_parameters())
    assert names == ["A_log", "D", "conv_b", "conv_w", "dt_bias", "in_proj.w",
                     "out_norm.scale", "out_proj.w"]
    assert mod.conv_w.shape == params["conv_w"].shape == (4, 64 + 16)
    fresh = tssm.Mamba2(tssm.SSMConfig(**MIXER))
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    _close(fresh.A_log.detach(), params["A_log"], atol=1e-6)
    assert float(fresh.D.detach().min()) == 1.0
    assert float(fresh.dt_bias.detach().abs().max()) == 0.0


def test_chunked_forward_matches_reference(mixer):
    params, mod, u = mixer
    want = jssm.mamba2_forward(params, jssm.SSMConfig(**MIXER), jnp.asarray(u))
    with torch.no_grad():
        got = mod(torch.from_numpy(u))
    assert got.shape == (2, 16, 32)
    _close(got, want)


def test_decode_and_cache_match_reference(mixer):
    params, mod, u = mixer
    jcfg = jssm.SSMConfig(**MIXER)
    jcache = jssm.init_ssm_cache(2, jcfg)
    cache = {k: v[0] for k, v in tssm.init_ssm_cache(2, mod.cfg, torch.float32).items()}
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    with torch.no_grad():
        for t in range(u.shape[1]):
            jy, jcache = jssm.mamba2_decode(params, jcfg, jnp.asarray(u[:, t:t + 1]), jcache)
            y = mod.decode(torch.from_numpy(u[:, t:t + 1]), cache)
            _close(y, jy)
    _close(cache["state"], jcache["state"])
    _close(cache["conv"], jcache["conv"])


def test_chunked_forward_matches_the_recurrent_oracle(mixer):
    _, mod, u = mixer
    with torch.no_grad():
        par = mod(torch.from_numpy(u))
        rec = tssm.mamba2_forward_reference(mod, torch.from_numpy(u))
    _close(par, rec)


def test_gradients_match_jax_grad(mixer):
    """The mixer's gradients, every parameter's and the input's: finite
    (the causal mask comes before ``exp``) and the reference's."""
    params, mod, u = mixer
    jcfg = jssm.SSMConfig(**MIXER)
    g = np.random.default_rng(3).normal(size=u.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jssm.mamba2_forward(p, jcfg, x) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(u))
    x = torch.from_numpy(u).requires_grad_()
    grads = torch.autograd.grad(torch.sum(mod(x) * torch.from_numpy(g)),
                                [x] + list(mod.parameters()))
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    _close(grads[0], jgx)
    for (name, _), got in zip(mod.named_parameters(), grads[1:]):
        want = jgp
        for key in name.split("."):
            want = want[key]
        _close(got, want)


def test_the_chunk_must_divide_the_sequence(mixer):
    _, mod, u = mixer
    with pytest.raises(AssertionError, match="must divide"):
        mod(torch.from_numpy(u[:, :10]))


# ---------------------------------------------------------------------------
# the Mamba2 model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jmodel = jax_build_model(JModelConfig(**SSM))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(ModelConfig(**SSM), _np_tree(params))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, SSM["vocab"], size=(B, S)).astype(np.int32)
    labels = rng.integers(0, SSM["vocab"], size=(B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    return jmodel, params, tmodel, jb, tb


def test_plan_and_cache_dtypes():
    model = build_model(ModelConfig(**SSM), "cpu")
    assert [(sp.kind, sp.n) for sp in model.plan] == [("mamba", 2)]
    bf16 = build_model(dataclasses.replace(ModelConfig(**SSM), dtype="bfloat16"), "cpu")
    cache = bf16.init_cache(B, S)[0]
    assert cache["state"].dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16
    assert tuple(cache["state"].shape) == (2, B, 2, 64, 16)
    assert tuple(cache["conv"].shape) == (2, B, 3, 2 * 64 + 2 * 16)


def test_loss_gradients_and_logits_match_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    (jl, _), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb)
    tl, tmet = tmodel.loss(tb)
    _close(float(tl.detach()), float(jl))
    assert float(tmet["aux_loss"]) == 0.0
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    gmodel = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
        for a, b in zip(jax.tree.leaves(lm_to_reference(gmodel)), jax.tree.leaves(_np_tree(jg))):
            _close(a, b)
        _close(tmodel.logits(tb), jmodel.logits(params, jb))


def test_prefill_and_serve_loop_match_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    _close(tsteps.make_prefill_step(tmodel)(tb), jsteps.make_prefill_step(jmodel)(params, jb))
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
    _close(got_logits, want_logits)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_split_inside_the_mamba_stack_matches_reference(pair):
    """cut_layer 1 of the 2-layer stack: each half holds one Mamba2 layer;
    the cut activations, the AP's loss and the split's round trips."""
    jmodel, params, tmodel, jb, tb = pair
    client, ap, slices = tmodel.split_plans()
    assert [(p.kind, p.n) for p in client] == [("mamba", 1)] == [(p.kind, p.n) for p in ap]
    assert slices == [(0, 1, 2)]
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
    _, params, tmodel, _, _ = pair
    back, want = lm_to_reference(tmodel), _np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_stacked_mamba_slot_is_bit_equal_to_its_plain_model():
    """``StackedMamba2`` runs a call a slot: slot r's loss and gradients
    are its plain model's, bit for bit."""
    cfg = ModelConfig(**SSM)
    models = [build_model(cfg, "cpu").init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    stacked = build_stacked_model(cfg, 2, device="cpu")
    for r, m in enumerate(models):
        stacked.load_slot(r, m)
    rng = np.random.default_rng(12)
    batches = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S))),
               "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S)))}
    losses = stacked.loss(batches)
    grads = torch.autograd.grad(losses.sum(), list(stacked.parameters()))
    for r, m in enumerate(models):
        loss, _ = m.loss({k: v[r] for k, v in batches.items()})
        assert torch.equal(losses[r], loss), r
        for got, want in zip(grads, torch.autograd.grad(loss, list(m.parameters()))):
            assert torch.equal(got[r], want), r
