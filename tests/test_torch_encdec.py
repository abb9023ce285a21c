"""Parity of the port's encoder-decoder (``arch_type="audio"``/``"encdec"``:
the ``enc`` kind in ``models.Encoder``, the ``dec_cross`` kind) and of the
blocks it brings with the JAX reference on the CPU.

``LayerNorm`` and ``GeluMLP`` (no reference model calls them: unit parity
only); ``gqa_cross_forward`` (Sq < Sk and Sq > Sk, a qkv bias); the
encoder (rope on 0..S-1, no qk-norm even where the config sets it); the
plain non-causal B5 gradient against ``jax.grad`` of the reference's
``attend`` under its mask (Sq = Sk, Sq < Sk, Sq > Sk, a window); the smoke
SeamlessM4T-medium (2 + 2 layers, d_model 256) with frames drawn from a
seed: the loss and every gradient, the logits, ``encode``, the prefill
step, ``client_forward`` (the memory after the tokens) and ``ap_forward``
(split again at the token count), ``convert``'s round trips, the serve
loop and ``decode_step`` with a memory; SeamlessM4T-medium's 977,758,208
parameters; ``decode_structs``/``input_specs`` against the reference's
four values (the memory (B, min(4,096, S // 8), d_model)); the entry
points: ``serve`` on the CPU, ``from_lm`` and ``train`` refused (no round
over an encoder-decoder exists in the reference).  f32 values within rtol
1e-4 and atol 1e-5."""
import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch.shapes import SHAPES as JSHAPES
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build_model as jax_build_model
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_split_from_reference,
                                 lm_split_to_reference, lm_to_reference)
from repro_torch.core import from_lm
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import Model, ModelConfig, build_model, build_plan, build_stacked_model
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttfm
from _torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, S, FRAMES, PROMPT, NEW = 2, 16, 12, 8, 6
ARCH = "seamless-m4t-medium"
SEAMLESS_PARAMS = 977_758_208


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


def _load(module, tree):
    """A reference parameter dict into a module named by its paths."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = tree
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.from_numpy(np.array(leaf)))
    return module


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def test_layernorm_matches_reference():
    """f32 with the biased variance; a bf16 input comes back bf16."""
    params = {"scale": _normal(1, (48,)), "bias": _normal(2, (48,))}
    x = _normal(3, (3, 5, 48)) * 4 + 1
    norm = _load(tblocks.LayerNorm(48), params)
    _close(norm(torch.from_numpy(x)).detach(), jblocks.layernorm(params, jnp.asarray(x)))
    assert norm(torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16
    fresh = tblocks.LayerNorm(8)
    fresh.reset_parameters()
    assert torch.equal(fresh.scale.detach(), torch.ones(8))
    assert torch.equal(fresh.bias.detach(), torch.zeros(8))


def test_gelu_mlp_matches_reference():
    """``jax.nn.gelu``'s default, the tanh approximation, and the biases."""
    params = jblocks.gelu_mlp_init(jax.random.PRNGKey(0), 32, 64)
    params = jax.tree.map(lambda a: a + 0.1, params)           # non-zero biases
    x = _normal(4, (2, 7, 32)) * 2
    mlp = _load(tblocks.GeluMLP(32, 64), params)
    _close(mlp(torch.from_numpy(x)).detach(), jblocks.gelu_mlp(params, jnp.asarray(x)))


@pytest.mark.parametrize("sq,sk", [(5, 12), (12, 5)])
def test_gqa_cross_forward_matches_reference(sq, sk):
    """No rope, no qk-norm (even where the config sets it), every memory
    position live; GQA 4/2 with a qkv bias."""
    jcfg = jattn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16, qkv_bias=True,
                            qk_norm=True)
    params = jax.tree.map(lambda a: a + 0.05, jattn.gqa_init(jax.random.PRNGKey(1), jcfg))
    attn = _load(tattn.GQA(tattn.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                                            qkv_bias=True, qk_norm=True)), params)
    x, mem = _normal(5, (2, sq, 32)), _normal(6, (2, sk, 32))
    want = jattn.gqa_cross_forward(params, jcfg, jnp.asarray(x), jnp.asarray(mem))
    got = tattn.gqa_cross_forward(attn, torch.from_numpy(x), torch.from_numpy(mem))
    assert got.shape == (2, sq, 32)
    _close(got.detach(), want)


# (B, Sq, Sk, H, Hkv, D, window): Sq = Sk, Sq < Sk, Sq > Sk, a window with
# every row live
NON_CAUSAL_GRAD = {"self": (2, 24, 24, 4, 2, 16, 0), "sq_lt_sk": (1, 10, 30, 4, 1, 32, 0),
                   "sq_gt_sk": (2, 30, 11, 2, 2, 16, 0),
                   "window": (1, 40, 30, 4, 2, 32, 12)}


@pytest.mark.parametrize("case", sorted(NON_CAUSAL_GRAD))
def test_plain_non_causal_gradient_matches_jax_autodiff(case):
    """B5's plain version with ``causal=False`` (the yardstick of the
    card's non-causal backward) differentiated by autograd, against
    ``jax.grad`` of the reference's ``attend`` under the same mask (all
    true without a window)."""
    b, sq, sk, h, hkv, d, window = NON_CAUSAL_GRAD[case]
    assert not tfa.has_dead_rows(sq, sk, window, False)
    q, k, v = _normal(7, (b, sq, h, d)), _normal(8, (b, sk, hkv, d)), _normal(9, (b, sk, hkv, d))
    g = _normal(10, (b, sq, h, d))
    mask = tfa.causal_mask(torch.arange(sq), torch.arange(sk), window, causal=False)
    if not window:
        assert bool(mask.all())

    def jloss(q_, k_, v_):
        out = jattn.attend(q_, jattn._repeat_kv(k_, h // hkv), jattn._repeat_kv(v_, h // hkv),
                           jnp.asarray(mask.numpy()), 1.0 / math.sqrt(d))
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    loss = torch.sum(tops.flash_attention(tq, tk, tv, causal=False, window=window)
                     * torch.from_numpy(g))
    for got, w in zip(torch.autograd.grad(loss, (tq, tk, tv)), want):
        _close(got, w)


# ---------------------------------------------------------------------------
# the encoder-decoder
# ---------------------------------------------------------------------------

def _smoke_cfg(**changes):
    return dataclasses.replace(jconfigs.get_smoke_config(ARCH), **changes)


@pytest.fixture(scope="module")
def pair():
    """The smoke SeamlessM4T-medium (cut 1: the client holds the encoder and
    one decoder layer), the reference's init carried across; tokens,
    labels and frames from a seed."""
    cfg = _smoke_cfg()
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(ModelConfig(**dataclasses.asdict(cfg)), _np_tree(params))
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    frames = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
          "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long(),
          "frames": torch.from_numpy(frames)}
    return jmodel, params, tmodel, jb, tb


def test_plan_parameters_and_no_stacked_form():
    """The plan and parameter count; the protocol's stacked form
    (``from_lm``'s) is refused, while the launch round step's
    ``StackedModel`` holds every slot's encoder and refuses a split (the
    cut message carries the memory)."""
    cfg = tconfigs.get_config(ARCH)
    model = Model(cfg, build_plan(cfg), "meta")
    assert [(sp.kind, sp.n) for sp in model.plan] == [("dec_cross", 12)]
    assert model.encoder.stacks[0].kind == "enc" and model.encoder.stacks[0].n == 12
    assert sum(p.numel() for p in model.parameters()) == SEAMLESS_PARAMS
    assert all(build_plan(tconfigs.get_config(a)) for a in tconfigs.list_archs())
    with pytest.raises(ValueError, match="no Pigeon-SL round"):
        from_lm(build_model(tconfigs.get_smoke_config(ARCH), "cpu"))
    stacked = build_stacked_model(tconfigs.get_smoke_config(ARCH), 2, device="cpu")
    assert stacked.encoder.stacks[0].n == 2
    with pytest.raises(ValueError, match="from_lm takes no encoder-decoder"):
        stacked.split_params()


def test_stacked_round_step_matches_reference():
    """The launch layer's round step over two slots of the smoke
    SeamlessM4T-medium (each slot encoding its own frames) against the
    reference's ``make_pigeon_round_step`` (its vmap over the slots) from
    the same two inits: ``sel`` exactly, the validation losses and the
    winner's parameters within the module's tolerances."""
    from repro_torch.convert import lm_slot_to_reference, lm_stack_from_reference
    cfg = _smoke_cfg()
    jm = jax_build_model(cfg)
    trees = [_np_tree(jax.jit(jm.init)(jax.random.PRNGKey(s))) for s in (0, 1)]
    rng = np.random.default_rng(9)
    batches = {k: rng.integers(0, cfg.vocab, (2, B, S)).astype(np.int32)
               for k in ("tokens", "labels")}
    batches["frames"] = rng.normal(size=(2, B, FRAMES, cfg.d_model)).astype(np.float32)
    val = {k: rng.integers(0, cfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
    val["frames"] = rng.normal(size=(B, FRAMES, cfg.d_model)).astype(np.float32)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    new, vl, sel = jax.jit(jsteps.make_pigeon_round_step(jm, 0.1))(
        stacked, {k: jnp.asarray(v) for k, v in batches.items()},
        {k: jnp.asarray(v) for k, v in val.items()})
    tcfg = ModelConfig(**dataclasses.asdict(cfg))
    model = lm_stack_from_reference(tcfg, trees)
    tvl, tsel = tsteps.make_pigeon_round_step(model, 0.1)(
        {k: torch.from_numpy(v) for k, v in batches.items()},
        {k: torch.from_numpy(v) for k, v in val.items()})
    assert int(tsel) == int(sel)
    _close(tvl.numpy(), np.asarray(vl))
    got, want = lm_slot_to_reference(model, 0), jax.tree.map(lambda x: np.asarray(x[0]), new)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(a, b)


def test_encoder_matches_reference(pair):
    """``encode``: the bidirectional layers (rope on 0..F-1, no qk-norm
    even where the config sets it) and the encoder's norm; one layer alone
    too, with qk-norm set."""
    jmodel, params, tmodel, jb, tb = pair
    with torch.no_grad():
        _close(tmodel.encode(tb), jmodel.encode(params, jb))
    cfg = _smoke_cfg(qk_norm=True)
    layer_params = jtfm._encdec_enc_init(cfg, jax.random.PRNGKey(5))
    layer = _load(ttfm.EncoderLayer(ModelConfig(**dataclasses.asdict(cfg))), layer_params)
    assert hasattr(layer.attn, "q_norm")
    x = _normal(11, (B, FRAMES, cfg.d_model))
    with torch.no_grad():
        _close(layer(torch.from_numpy(x)), jtfm._encdec_enc_layer(cfg, layer_params,
                                                                    jnp.asarray(x)))


def test_loss_gradients_and_logits_match_reference(pair):
    jmodel, params, tmodel, jb, tb = pair
    (jl, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(params, jb)
    tl, _ = tmodel.loss(tb)
    _close(float(tl.detach()), float(jl))
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    gmodel = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
        back, want = lm_to_reference(gmodel), _np_tree(jg)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            _close(a, b)
        _close(tmodel.logits(tb), jmodel.logits(params, jb))
    _close(tsteps.make_prefill_step(tmodel)(tb), jsteps.make_prefill_step(jmodel)(params, jb))


def test_client_and_ap_halves_match_reference(pair):
    """The client sends [x, memory] along the sequence; the AP splits it at
    the token count; the split's round trips carry the encoder in gamma."""
    jmodel, params, tmodel, jb, tb = pair
    jg, jp = jmodel.split_params(params)
    assert "encoder" in jg
    jacts = jmodel.client_forward(jg, jb)
    g, p = tmodel.split_params()
    assert g.encoder is tmodel.encoder
    with torch.no_grad():
        acts = tmodel.client_forward(g, tb)
        loss, _ = tmodel.ap_forward(p, acts, tb)
    assert acts.shape == (B, S + FRAMES, tmodel.cfg.d_model)
    _close(acts, jacts)
    _close(float(loss), float(jmodel.ap_forward(jp, jacts, jb)[0]))
    g2, p2 = lm_split_from_reference(tmodel.cfg, _np_tree(jg), _np_tree(jp))
    for a, b in zip(jax.tree.leaves(lm_split_to_reference(tmodel, g2, p2)),
                    jax.tree.leaves(_np_tree((jg, jp)))):
        np.testing.assert_array_equal(a, b)
    merged = tmodel.merge_params(g2, p2)
    with torch.no_grad():
        _close(float(merged.loss(tb)[0]), float(jmodel.loss(params, jb)[0]))


def test_convert_round_trip_is_exact(pair):
    _, params, tmodel, _, _ = pair
    back, want = lm_to_reference(tmodel), _np_tree(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_serve_loop_with_a_memory_matches_reference(pair):
    """``decode_step`` with the encoder's memory: the self-attention's KV
    cache, the cross-attention over the memory every step; the prompt
    logits and the greedy tokens."""
    jmodel, params, tmodel, jb, tb = pair
    jmem = jmodel.encode(params, jb)
    with torch.no_grad():
        mem = tmodel.encode(tb)
    prompts = np.asarray(jb["tokens"])[:, :PROMPT]
    step = jax.jit(lambda p, c, t, i: jmodel.decode_step(p, c, t, i, jmem))
    cache = jmodel.init_cache(B, PROMPT + NEW)
    logits = None
    for i in range(PROMPT):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]), i)
    want_logits, want = np.asarray(logits), []
    for j in range(NEW):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, PROMPT + j)
    got, got_logits = tserve.greedy_decode(tsteps.make_serve_step(tmodel),
                                           tmodel.init_cache(B, PROMPT + NEW),
                                           torch.from_numpy(prompts.copy()).long(), NEW, mem)
    _close(got_logits, want_logits)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_decode_structs_and_input_specs_match_reference(shape):
    """The repaired ``decode_structs`` gives the reference's four values (the
    memory (B, min(4,096, S // 8), d_model) in the model's dtype), and the
    decode step's arguments end with it; a train batch carries the frames."""
    cfg = tconfigs.get_config(ARCH)
    spec = tsteps.input_specs(cfg, shape)
    jcfg = jsteps.apply_shape_settings(jconfigs.get_config(ARCH), JSHAPES[shape])
    if shape == "train_4k":
        want = jsteps.batch_struct(jcfg, JSHAPES[shape])
        assert {k: tuple(v.shape) for k, v in spec.args[0].items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert spec.args[0]["frames"].dtype == torch.bfloat16
        return
    jtok, jidx, jcache, jmem = jsteps.decode_structs(jcfg, jax_build_model(jcfg), JSHAPES[shape])
    tok, idx, cache, mem = tsteps.decode_structs(spec.model.cfg, spec.model, tsteps.SHAPES[shape])
    assert tok.shape == jtok.shape and idx.shape == jidx.shape
    assert tuple(mem.shape) == tuple(jmem.shape) == (128, 4096, 1024)
    assert mem.dtype == torch.bfloat16 and str(jmem.dtype) == "bfloat16"
    assert sorted(tuple(t.shape) for c in cache for t in c.values()) == \
        sorted(tuple(x.shape) for x in jax.tree.leaves(jcache))
    assert spec.args[-1].shape == mem.shape and len(spec.args) == 4


def test_entry_points_serve_and_refuse_the_round(capsys):
    """``serve`` steps the reference's memory stand-in (0.1 everywhere, 8
    frames); ``from_lm`` and ``train`` refuse an encoder-decoder: the
    reference's ``from_lm`` sends tokens only, so no round over one
    exists."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                 "--new-tokens", "2"])
    assert f"arch={ARCH}-smoke" in capsys.readouterr().out
    with pytest.raises(ValueError, match="sends tokens only"):
        from_lm(build_model(tconfigs.get_smoke_config(ARCH), "cpu"))
    with pytest.raises(ValueError, match="sends tokens only"):
        ttrain.main(["--arch", ARCH, "--device", "cpu", "--rounds", "1", "--clients", "2",
                     "--batch", "2"])
