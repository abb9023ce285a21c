"""Parity of the port's MoE and MLA (``models/moe.py``, ``models/
attention.py``'s MLA, the ``dense_mlp`` and ``moe`` stack kinds) with the
JAX reference on the CPU.

  * ``capacity``, ``route`` and ``moe_forward`` against the reference's:
    routing ids and kept pairs exactly equal, values within f32 atol 1e-5,
    at a generous, the default and a tight capacity (tokens dropped), with
    and without shared experts, and on router fixtures built to tie (the
    lower expert wins, as ``jax.lax.top_k`` breaks ties); ``moe_forward``
    against the loop over experts where nothing drops.
  * ``mla_forward`` (whole and query-chunked) and ``mla_decode`` (the
    absorbed form over the latent cache) against the reference's.
  * DeepSeek-V2-Lite (MLA, a dense first layer, shared experts) and
    Qwen3-30B-A3B (GQA through B5 and B6's plain versions) at
    ``reduce_config`` size: the converted reference init, the loss with its
    router loss, every gradient, logits (atol 1e-4), the split halves (the
    AP's loss carries the AP's router losses, the client's are dropped),
    decode logits (atol 2e-4) and greedy tokens, ``convert``'s round trips.
  * The cluster-stacked forms slot by slot bit-equal to their plain models.
  * ``input_specs`` on the meta device against the reference's shapes;
    ``"moe_shard"`` (the 16-group dispatch) against the reference's loss.

``tests/test_torch_moe_round.py`` holds the Pigeon-SL round over a tiny
DeepSeek-V2-Lite and the entry points."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.launch.shapes import SHAPES as JSHAPES
from repro.models import attention as jattn
from repro.models import build_model as jax_build_model
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_reference, lm_slot_to_reference,
                                 lm_split_from_reference, lm_split_to_reference,
                                 lm_stack_from_reference, lm_to_reference)
from repro_torch.kernels import build as tbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import ModelConfig, build_model, build_stacked_model
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from _torch_threads import one_thread  # noqa: F401

ATOL = 1e-5
FORWARD_ATOL = 1e-4
DECODE_ATOL = 2e-4
B, S, PROMPT, NEW = 2, 16, 8, 6


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _moe_pair(seed, **kw):
    cfg = jmoe.MoEConfig(**{**dict(d_model=32, d_expert=16, n_experts=8, top_k=2), **kw})
    p = jmoe.moe_init(jax.random.PRNGKey(seed), cfg)
    shared = None
    if "shared" in p:
        shared = tuple(_t(p["shared"][n]["w"]) for n in ("gate", "up", "down"))
    w = tmoe.MoEWeights(_t(p["router"]), _t(p["gate"]), _t(p["up"]), _t(p["down"]), shared)
    return cfg, tmoe.MoEConfig(**cfg._asdict()), p, w


def _reference_keep(ids, cfg, cap):
    """The reference's slot rule in numpy, from its ids."""
    flat = np.asarray(ids).reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    slot = (np.cumsum(onehot, axis=0) - 1)[np.arange(flat.size), flat]
    return slot < cap


def test_capacity_matches_reference():
    for kw in (dict(), dict(capacity_factor=0.25), dict(top_k=6, n_experts=64),
               dict(top_k=8, n_experts=128, capacity_factor=2.0)):
        jcfg = jmoe.MoEConfig(**{**dict(d_model=32, d_expert=16, n_experts=8, top_k=2), **kw})
        tcfg = tmoe.MoEConfig(**jcfg._asdict())
        for t in (1, 4, 7, 32, 480, 1920, 2048):
            assert tmoe.capacity(t, tcfg) == jmoe.capacity(t, jcfg), (kw, t)


MOE_CASES = {"default": dict(), "generous": dict(capacity_factor=4.0),
             "tight": dict(capacity_factor=0.25),
             "shared_tight": dict(n_shared=2, capacity_factor=0.5),
             "top1": dict(top_k=1, n_experts=4)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_route_and_moe_forward_match_reference(case):
    jcfg, tcfg, p, w = _moe_pair(1, **MOE_CASES[case])
    x = np.random.default_rng(2).normal(size=(2, 24, 32)).astype(np.float32)
    jw, jids, jaux = jmoe.route(p, jcfg, jnp.asarray(x.reshape(48, 32)))
    tw, tids, taux = tmoe.route(w.router, tcfg, _t(x).reshape(48, 32))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=ATOL)
    cap = tmoe.capacity(48, tcfg)
    _, keep = tmoe.dispatch(tids, tcfg, cap)
    want_keep = _reference_keep(jids, jcfg, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if case in ("tight", "shared_tight"):
        assert (~want_keep).sum() > 0
    if case == "generous":
        assert want_keep.all()
    jout, jaux2 = jmoe.moe_forward(p, jcfg, jnp.asarray(x))
    tout, taux2 = tmoe.moe_forward(w, tcfg, _t(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(float(taux2), float(jaux2), atol=ATOL)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_is_the_loop_over_experts_where_nothing_drops(shared):
    jcfg, tcfg, p, w = _moe_pair(3, capacity_factor=4.0, n_shared=shared)
    x = _t(np.random.default_rng(4).normal(size=(2, 12, 32)))
    got, aux = tmoe.moe_forward(w, tcfg, x)
    want, aux_ref = tmoe.moe_forward_reference(w, tcfg, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    assert float(aux) == float(aux_ref)
    jwant, _ = jmoe.moe_forward_reference(p, jcfg, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=ATOL)


@pytest.mark.parametrize("fixture", ["all_equal", "duplicate_columns"])
def test_top_k_ties_go_to_the_lower_expert(fixture):
    """Probabilities that tie exactly: every expert (a zero router), or
    pairs of experts with equal router columns.  ``jax.lax.top_k`` takes
    the lower index; so does the port (``torch.topk`` would take the
    higher one on the CPU)."""
    jcfg, tcfg, p, w = _moe_pair(5, top_k=3, capacity_factor=0.5)
    router = np.array(p["router"])
    if fixture == "all_equal":
        router[:] = 0.0
    else:
        for a, b in ((1, 6), (2, 5), (0, 7)):
            router[:, b] = router[:, a]
    p = dict(p, router=jnp.asarray(router))
    w = w._replace(router=_t(router))
    x = np.random.default_rng(6).normal(size=(2, 16, 32)).astype(np.float32)
    _, jids, _ = jmoe.route(p, jcfg, jnp.asarray(x.reshape(32, 32)))
    _, tids, _ = tmoe.route(w.router, tcfg, _t(x).reshape(32, 32))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    if fixture == "all_equal":
        assert (np.asarray(jids) == np.arange(3)).all()
    else:
        assert len(set(map(tuple, np.asarray(jids)))) > 1
    jout, _ = jmoe.moe_forward(p, jcfg, jnp.asarray(x))
    tout, _ = tmoe.moe_forward(w, tcfg, _t(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair(seed, q_chunk=0):
    cfg = jattn.MLAConfig(d_model=64, n_heads=4, head_dim=16, kv_lora_rank=32, rope_dim=8,
                          q_chunk=q_chunk)
    p = jattn.mla_init(jax.random.PRNGKey(seed), cfg)
    w = tattn.MLAWeights(_t(p["wq"]["w"]), _t(p["w_dkv"]["w"]), _t(p["kv_norm"]["scale"]),
                         _t(p["w_uk"]["w"]), _t(p["w_uv"]["w"]), _t(p["wo"]["w"]))
    return cfg, tattn.MLAConfig(**cfg._asdict()), p, w


@pytest.mark.parametrize("q_chunk", [0, 8])
def test_mla_forward_matches_reference(q_chunk):
    jcfg, tcfg, p, w = _mla_pair(7, q_chunk)
    x = np.random.default_rng(8).normal(size=(2, 24, 64)).astype(np.float32)
    want = jattn.mla_forward(p, jcfg, jnp.asarray(x))
    got = tattn.mla_forward(w, tcfg, _t(x), torch.arange(24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_mla_decode_matches_reference_and_the_forward():
    """Each step of the absorbed decode over the latent cache: the
    reference's output and cache; the last step's output is the full
    forward's last row."""
    jcfg, tcfg, p, w = _mla_pair(9)
    n = 10
    x = np.random.default_rng(10).normal(size=(2, n, 64)).astype(np.float32)
    jcache = jattn.init_mla_cache(2, n, jcfg)
    tcache = {k: v[0] for k, v in tattn.init_mla_cache(1, 2, n, tcfg, torch.float32).items()}
    for i in range(n):
        jy, jcache = jattn.mla_decode(p, jcfg, jnp.asarray(x[:, i:i + 1]), jcache, i)
        ty = tattn.mla_decode(w, tcfg, _t(x[:, i:i + 1]), tcache, i)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=DECODE_ATOL)
    for name in ("latent", "k_rope"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), atol=ATOL)
    full = tattn.mla_forward(w, tcfg, _t(x), torch.arange(n))
    np.testing.assert_allclose(ty[:, 0].numpy(), full[:, -1].numpy(), atol=DECODE_ATOL)


# ---------------------------------------------------------------------------
# the models at smoke size
# ---------------------------------------------------------------------------

ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = jconfigs.get_smoke_config(request.param)
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(_port_cfg(cfg), _np_tree(params))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    return jmodel, params, tmodel, tokens, labels


def test_plans_and_param_counts():
    for arch, kinds in zip(ARCHS, (["dense_mlp", "moe"], ["moe"])):
        cfg = tconfigs.get_smoke_config(arch)
        model = build_model(cfg, "cpu")
        assert [sp.kind for sp in model.plan] == kinds
        emb = 2 * cfg.vocab * cfg.d_model
        norms = sum(p.numel() for n, p in model.named_parameters()
                    if n.endswith("scale"))
        assert sum(p.numel() for p in model.parameters()) == cfg.param_count() + norms, arch
        assert emb < cfg.param_count()
    assert tconfigs.get_config("deepseek-v2-lite-16b").param_count() == 15_706_357_760
    assert tconfigs.get_config("qwen3-moe-30b-a3b").param_count() == 30_531_911_680


def test_convert_round_trips_are_exact(pair):
    jmodel, params, tmodel, _, _ = pair
    want = _np_tree(params)
    back = lm_to_reference(tmodel)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    jg, jp = jmodel.split_params(params)
    g, p = lm_split_from_reference(tmodel.cfg, _np_tree(jg), _np_tree(jp))
    got = lm_split_to_reference(tmodel, g, p)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_np_tree((jg, jp)))):
        np.testing.assert_array_equal(a, b)
    stacked = lm_stack_from_reference(tmodel.cfg, [want, want])
    for a, b in zip(jax.tree.leaves(lm_slot_to_reference(stacked, 1)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_loss_gradients_and_logits_match_reference(pair):
    jmodel, params, tmodel, tokens, labels = pair
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    (jl, jmet), jg = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb)
    tl, tmet = tmodel.loss(tb)
    tmet = {k: v.detach() for k, v in tmet.items()}
    assert float(tmet["aux_loss"]) > 0
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), atol=ATOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), atol=ATOL)
    grads = torch.autograd.grad(tl, list(tmodel.parameters()))
    gmodel = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(gmodel.parameters(), grads):
            p.copy_(g)
    for a, b in zip(jax.tree.leaves(lm_to_reference(gmodel)), jax.tree.leaves(_np_tree(jg))):
        np.testing.assert_allclose(a, b, atol=ATOL)
    with torch.no_grad():
        np.testing.assert_allclose(tmodel.logits(tb).numpy(),
                                   np.asarray(jmodel.logits(params, jb)), atol=FORWARD_ATOL)


def test_split_halves_match_reference(pair):
    """The client's cut activations, and the AP's loss with the AP's router
    losses (the client's are dropped, as in the reference)."""
    jmodel, params, tmodel, tokens, labels = pair
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens).long(), "labels": torch.from_numpy(labels).long()}
    jg, jp = jmodel.split_params(params)
    jacts = jmodel.client_forward(jg, jb)
    jl, jmet = jmodel.ap_forward(jp, jacts, jb)
    g, p = tmodel.split_params()
    with torch.no_grad():
        acts = tmodel.client_forward(g, tb)
        tl, tmet = tmodel.ap_forward(p, acts, tb)
    np.testing.assert_allclose(acts.numpy(), np.asarray(jacts), atol=FORWARD_ATOL)
    np.testing.assert_allclose(float(tl), float(jl), atol=ATOL)
    np.testing.assert_allclose(float(tmet["aux_loss"]), float(jmet["aux_loss"]), atol=ATOL)
    assert float(tmet["aux_loss"]) > 0


def _jax_serve_loop(jmodel, params, prompts, new):
    cache = jmodel.init_cache(prompts.shape[0], prompts.shape[1] + new)
    step = jax.jit(jmodel.decode_step)
    logits_at = []
    for i in range(prompts.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]), i)
    logits_at.append(np.asarray(logits))
    out = []
    for j in range(new):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, prompts.shape[1] + j)
    return np.concatenate(out, axis=1), logits_at[0]


def test_decode_matches_reference(pair):
    """The serve loop (the prompt stepped through the decode path, then
    greedy tokens) on the MLA latent cache or the KV cache: the prompt's
    last logits within 2e-4 and the tokens equal to the reference's."""
    jmodel, params, tmodel, tokens, _ = pair
    prompts = tokens[:, :PROMPT]
    want, want_logits = _jax_serve_loop(jmodel, params, prompts, NEW)
    got, logits = tserve.greedy_decode(tsteps.make_serve_step(tmodel),
                                       tmodel.init_cache(B, PROMPT + NEW),
                                       torch.from_numpy(prompts).long(), NEW)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=DECODE_ATOL)
    np.testing.assert_array_equal(got.numpy(), want)
    cache = tmodel.init_cache(B, 4)
    if tmodel.cfg.kv_lora_rank:
        assert set(cache[0]) == {"latent", "k_rope"}
        assert cache[1]["latent"].shape == (tmodel.plan[1].n, B, 4, tmodel.cfg.kv_lora_rank)


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_slot_is_bit_equal_to_its_plain_model(arch):
    """Slot r of a stacked MoE (MLA or GQA attention, each slot's router
    and experts a call a slot) computes its plain model's loss (with its
    own router loss), gradients and cut activations bit for bit."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), cut_layer=1, remat=True)
    models = [build_model(cfg, "cpu").init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    stacked = build_stacked_model(cfg, 2, device="cpu")
    for r, m in enumerate(models):
        stacked.load_slot(r, m)
    rng = np.random.default_rng(12)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S)))
    batches = {"tokens": toks, "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, B, S)))}
    losses = stacked.loss(batches)
    grads = torch.autograd.grad(losses.sum(), list(stacked.parameters()))
    gamma, phi = stacked.split_params()
    acts = stacked.client_forward(gamma, toks)
    ap = stacked.ap_losses(phi, acts, batches["labels"])
    for r, m in enumerate(models):
        loss, _ = m.loss({k: v[r] for k, v in batches.items()})
        assert torch.equal(losses[r], loss), r
        for got, want in zip(grads, torch.autograd.grad(loss, list(m.parameters()))):
            assert torch.equal(got[r], want), r
        g, p = m.split_params()
        a = m.client_forward(g, {"tokens": toks[r]})
        assert torch.equal(acts[r], a), r
        assert torch.equal(ap[r], m.ap_forward(p, a, {"labels": batches["labels"][r]})[0]), r


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k", "pigeon"])
def test_input_specs_give_the_reference_shapes(arch, shape):
    cfg = tconfigs.get_config(arch)
    kw = dict(pigeon_clusters=2) if shape == "pigeon" else {}
    name = "train_4k" if shape == "pigeon" else shape
    spec = tsteps.input_specs(cfg, name, **kw)
    jcfg = jsteps.apply_shape_settings(jconfigs.get_config(arch), JSHAPES[name])
    if name == "decode_32k":
        cache, tokens, index = spec.args
        jtok, jidx, jcache, _ = jsteps.decode_structs(jcfg, jax_build_model(jcfg),
                                                      JSHAPES[name])
        assert tokens.shape == jtok.shape and index.shape == jidx.shape
        got = sorted(tuple(t.shape) for c in cache for t in c.values())
        assert got == sorted(tuple(x.shape) for x in jax.tree.leaves(jcache))
        return
    want = jsteps.batch_struct(jcfg, JSHAPES[name], cluster_dim=2 if kw else 0)
    assert {k: tuple(v.shape) for k, v in spec.args[0].items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert all(p.device.type == "meta" for p in spec.model.parameters())


def test_moe_shard_is_multi_card():
    """``"moe_shard"`` (once refused as multi-card) builds and runs on one
    card: the smoke DeepSeek-V2-Lite at a batch that takes the reference's
    16-group dispatch (T = 64 = 16 E) gives the reference's loss and router
    loss, the reference run under a one-device (data, model) mesh, as its
    sharding constraints need."""
    from jax.sharding import Mesh
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("deepseek-v2-lite-16b"),
                               optimizations=("moe_shard",))
    cfg = _port_cfg(jcfg)
    assert tmoe.local_dispatch_taken(tmoe.MoEConfig(
        cfg.d_model, cfg.d_expert, cfg.n_experts, cfg.top_k, shard_groups=16), 64)
    jmodel = jax_build_model(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = lm_from_reference(cfg, _np_tree(params))
    assert all(stack.layers[-1].moe.cfg.shard_groups == 16 for stack in tmodel.stacks
               if stack.kind == "moe")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, size=(4, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(4, 16)).astype(np.int32)
    with Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")):
        jl, jmet = jax.jit(jmodel.loss)(params, {"tokens": jnp.asarray(tokens),
                                                 "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tl, tmet = tmodel.loss({"tokens": torch.from_numpy(tokens).long(),
                                "labels": torch.from_numpy(labels).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tmet["aux_loss"]), float(jmet["aux_loss"]), rtol=1e-5)
