"""Gemma3-12B, H2O-Danube-1.8B and Qwen2.5-14B, the three dense
configurations that ``chip_smoke.py``'s phase 20 runs on the card, against
the JAX reference on the CPU at ``reduce_config`` size (2 layers, d_model
256, vocab 512; the weights carried across by ``convert.py``):

* the loss and every gradient against ``jax.grad`` of the reference's
  loss, and the train step's updated parameters against the reference's
  train step, f32, atol 1e-5 (``tests/test_torch_train.py``'s bound), on a
  sequence of 40 past the smoke window of 16 (Gemma3's first layer local
  under it, its second global; Danube's both local; Qwen2.5's QKV bias);
* the Pigeon-SL+ round over the smoke Danube (its window 16 under a
  40-token sequence) on both of the port's engines: clusters, selection,
  acceptance, detections and wire bytes equal to the reference's
  ``run_pigeon`` exactly, losses and test accuracy within rtol 1e-4;
* the route plan of phase 20: ``attention_route``, ``attention_bwd_route``
  and ``decode_route`` on bf16 CPU tensors at each configuration's
  full-width heads, ``xent_route`` on meta tensors at its full head, and
  ``chip_smoke._dense_want``'s launches per counter and route.

``tests/test_torch_lm.py`` holds these configurations' forward, prefill,
decode and serve loop; they are not repeated here."""
import copy
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro import configs as jconfigs
from repro.data import build_lm_task as jax_build_lm_task
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build_model
import repro_torch.core as tcore
from repro_torch.configs import get_config
from repro_torch.convert import lm_from_reference, lm_split_from_reference, lm_to_reference
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import decode_attention as tda
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_xent as tfx
from repro_torch.launch.serve import serve_config
from repro_torch.launch.shapes import SHAPES, shape_settings
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ModelConfig, build_model
from _torch_threads import one_thread  # noqa: F401

ARCHS = ("gemma3-12b", "h2o-danube-1.8b", "qwen2.5-14b")
ATOL = 1e-5
ROUND_RTOL = 1e-4
B, S = 2, 40
LR = 0.05
TASK = dict(vocab=512, seq_len=S, m_clients=4, d_m=16, d_o=8, n_test=8, seed=0)
PCFG = dict(M=4, N=1, T=2, E=2, B=4, lr=5e-2, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")
FLOATS = ("val_losses", "train_losses", "test_acc")
TC, FMA = tfa.TENSOR_CORES, tfa.F32_FMA
#: the routes of each configuration's bf16 tensors at full width: B5's
#: forward and backward, B6, B4's forward and backward
ROUTES = {"gemma3-12b": (TC, TC, TC, TC, TC),
          "h2o-danube-1.8b": (TC, TC, TC, TC, TC),
          "qwen2.5-14b": (TC, TC, TC, TC, TC)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_dense", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_smoke_configs_are_what_the_tests_say():
    g, d, q = (jconfigs.get_smoke_config(a) for a in ARCHS)
    assert (g.n_layers, g.sliding_window, g.global_every, g.qk_norm) == (2, 16, 2, True)
    assert (d.n_layers, d.sliding_window, d.global_every) == (2, 16, 0)
    assert q.qkv_bias and not q.sliding_window
    assert S > g.sliding_window


def _pair(arch):
    cfg = jconfigs.get_smoke_config(arch)
    jmodel = jax_build_model(cfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    return jmodel, params, lm_from_reference(_port_cfg(cfg), _np_tree(params))


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)}
    return ({k: jax.numpy.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _assert_trees_close(got, want, what):
    assert jax.tree.structure(got) == jax.tree.structure(_np_tree(want)), what
    for path_leaf, w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        path, g = path_leaf
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=ATOL, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_every_gradient_match_reference(arch):
    jmodel, params, tmodel = _pair(arch)
    jb, tb = _batch(jmodel.cfg)
    (jloss, _), jgrads = jax.value_and_grad(jmodel.loss, has_aux=True)(params, jb)
    tloss, _ = tmodel.loss(tb)
    grads = torch.autograd.grad(tloss, list(tmodel.parameters()))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), atol=ATOL)
    holder = copy.deepcopy(tmodel)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    _assert_trees_close(lm_to_reference(holder), jgrads, f"{arch} gradient")
    new_params, jstep_loss = jax.jit(jax_make_train_step(jmodel, LR))(params, jb)
    step_loss = make_train_step(tmodel, LR)(tb)
    np.testing.assert_allclose(float(step_loss), float(jstep_loss), atol=ATOL)
    _assert_trees_close(lm_to_reference(tmodel), new_params, f"{arch} train step")


@pytest.fixture(scope="module")
def danube_round():
    """The reference's smoke-Danube split module, task and run_pigeon
    (Pigeon-SL+, label flip on client 0), and the port's module carrying
    the reference's initial (gamma, phi)."""
    cfg = jconfigs.get_smoke_config("h2o-danube-1.8b")
    jmodule = jcore.from_lm(jax_build_model(cfg))
    jdata = jax_build_lm_task(**TASK)
    jpcfg = jcore.ProtocolConfig(**PCFG)
    ref = jcore.run_pigeon(jmodule, jdata, jpcfg, {0}, jcore.Attack(jcore.LABEL_FLIP),
                           plus=True)
    _, k0 = jax.random.split(jax.random.PRNGKey(jpcfg.seed))   # run_pigeon's init key
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(_port_cfg(cfg), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(_port_cfg(cfg), "cpu")),
                                  init=lambda _g: copy.deepcopy(theta))
    return ref, tmodule, build_lm_task(**TASK), tcore.ProtocolConfig(**PCFG)


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_danube_round_matches_reference(engine, danube_round):
    ref, tmodule, data, pcfg = danube_round
    got = tcore.run_pigeon(tmodule, data, pcfg, {0}, tcore.Attack(tcore.LABEL_FLIP),
                           plus=True, engine=engine, device="cpu")
    assert len(got.rounds) == len(ref.rounds) == pcfg.T
    for rg, rr in zip(got.rounds, ref.rounds):
        for k in DISCRETE:
            assert rg[k] == rr[k], (engine, rr["round"], k)
        for k in FLOATS:
            np.testing.assert_allclose(rg[k], rr[k], rtol=ROUND_RTOL, atol=0,
                                       err_msg=f"{engine} round {rr['round']} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_routes_at_full_width_heads(arch):
    cfg = get_config(arch)
    d, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    g = torch.Generator().manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    q, k, v = draw(1, 16, h, d), draw(1, 16, hkv, d), draw(1, 16, hkv, d)
    q1 = draw(1, 1, h, d)
    hid = torch.empty((8, cfg.d_model), dtype=torch.bfloat16, device="meta")
    w = torch.empty((cfg.d_model, cfg.vocab), dtype=torch.bfloat16, device="meta")
    got = (tfa.attention_route(q, k, v), tfa.attention_bwd_route(q, k, v, q, q),
           tda.decode_route(q1, k, v), tfx.xent_route(hid, w), tfx.xent_bwd_route(hid, w))
    assert got == ROUTES[arch]
    # f32 keeps exact products: every route the f32-FMA one
    assert tfa.attention_route(q.float(), k.float(), v.float()) == FMA
    assert tda.decode_route(q1.float(), k.float(), v.float()) == FMA


@pytest.mark.parametrize("arch", ARCHS)
def test_phase20_launch_plan(arch):
    """``chip_smoke._dense_want``: the prefill B5 once a layer, the serve
    loop B6 once a layer and step, a train step (train_4k's remat) B5's
    forward twice a layer and its backward once, B4's forward and backward
    once, each under the counter of its route; the f32 check's plan on the
    f32-FMA routes; the round plans' counters (``_kernel_counters``)."""
    cs = _chip_smoke()
    fwd, bwd, dec, xf, xb = (("_tc" if r == TC else "") for r in ROUTES[arch])
    serve = serve_config(arch, full=True)
    n = serve.n_layers
    want = cs._dense_want(serve, 1 + cs.DENSE_NEW)
    assert cs._launched(want) == {
        "prefill": {f"flash_attention{fwd}": n},
        "serve": {f"decode_attention{dec}": n * (1 + cs.DENSE_NEW)}, "train": {
            f"flash_attention{fwd}": n, f"flash_attention_bwd{bwd}": n,
            f"fused_xent{xf}": 1, f"fused_xent_bwd{xb}": 1}}
    fam = cs.DENSE_FAMILIES[arch]
    train = dataclasses.replace(get_config(arch), n_layers=fam["train_layers"],
                                **shape_settings(SHAPES["train_4k"]))
    assert cs._launched({0: cs._dense_want(train)["train"]})[0] == {
        f"flash_attention{fwd}": 2 * train.n_layers,
        f"flash_attention_bwd{bwd}": train.n_layers,
        f"fused_xent{xf}": 1, f"fused_xent_bwd{xb}": 1}
    f32 = dataclasses.replace(get_config(arch), n_layers=fam["f32_layers"])
    assert cs._launched({0: cs._dense_want(f32)["train"]})[0] == {
        "flash_attention": f32.n_layers, "flash_attention_bwd": f32.n_layers,
        "fused_xent": 1, "fused_xent_bwd": 1}
    assert cs._kernel_counters(train) == {
        "flash_attention": f"flash_attention{fwd}",
        "flash_attention_bwd": f"flash_attention_bwd{bwd}",
        "decode_attention": f"decode_attention{dec}",
        "fused_xent": f"fused_xent{xf}", "fused_xent_bwd": f"fused_xent_bwd{xb}"}
    assert fam["params"] == get_config(arch).param_count()
    assert fam["serve"][1] > get_config(arch).sliding_window
    # the f32 check's sequence outruns the window; Gemma3's cut holds a
    # global layer (every global_every-th)
    assert not get_config(arch).sliding_window or \
        fam["f32_tokens"] > get_config(arch).sliding_window
    if get_config(arch).global_every:
        assert fam["f32_layers"] >= get_config(arch).global_every


def test_phase20_shapes_are_in_phase1s_lists():
    """Every shape phase 20 gives B5, B6 and B4 at full width is one that
    phase 1 holds against the plain versions (``SLICE_ATTN``,
    ``SLICE_DECODE``, ``SLICE_XENT``), on the path it names."""
    cs = _chip_smoke()
    attn = {(shape, path) for shape, path, _ in cs.SLICE_ATTN}
    decode = {(shape[:6], path) for shape, path in cs.SLICE_DECODE}
    xent = {(shape, path) for shape, path, _ in cs.SLICE_XENT}
    for arch, fam in cs.DENSE_FAMILIES.items():
        cfg = get_config(arch)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        windows = {cfg.sliding_window} | ({0} if cfg.global_every or not cfg.sliding_window
                                          else set())
        b, p = fam["serve"]
        label = fam["label"]
        for w in windows:
            assert ((b, p, *heads, w), f"{label}_prefill") in attn, (arch, w)
            assert ((cs.TRAIN_BATCH, cs.TRAIN_SEQ, *heads, w), f"{label}_train") in attn
            assert ((b, p + cs.DENSE_NEW, *heads, w), f"{label}_loop") in decode, (arch, w)
        assert ((cs.TRAIN_BATCH * cs.TRAIN_SEQ, cfg.d_model, cfg.vocab),
                f"{label}_train") in xent
