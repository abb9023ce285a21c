"""Parity of the port's dense LM serve path with the JAX reference on the
CPU: the configs and shapes, the converted reference init, ``forward``,
the prefill step, ``decode_step`` with its caches, and the greedy serve
loop.

The four dense families at ``reduce_config`` size (2 layers, d_model 256,
vocab 512): qwen3-8b (qk-norm), qwen2.5-14b (qkv bias), h2o-danube-1.8b
(window 16) and gemma3-12b (a local window-16 layer and a global one), plus
qwen3-8b with 2 KV heads so that the model runs GQA (``reduce_config``
keeps 4 query and 4 KV heads).  Tolerances: hidden states and prefill
logits atol 1e-4; decode logits and caches atol 2e-4, the bound of
``tests/test_models.py::test_decode_matches_forward``; greedy tokens
exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import make_markov_tokens as jax_markov_tokens
from repro.launch import shapes as jshapes
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import lm_from_reference, lm_to_reference
from repro_torch.data import make_markov_tokens
from repro_torch.kernels import build as tbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from _torch_threads import one_thread  # noqa: F401

B, S = 2, 32
PROMPT, NEW = 8, 8
FORWARD_ATOL = 1e-4
DECODE_ATOL = 2e-4


def _smoke(arch, **changes):
    return dataclasses.replace(jconfigs.get_smoke_config(arch), **changes)


CASES = {
    "qwen3-8b": lambda: _smoke("qwen3-8b"),
    "qwen2.5-14b": lambda: _smoke("qwen2.5-14b"),
    "h2o-danube-1.8b": lambda: _smoke("h2o-danube-1.8b"),
    "gemma3-12b": lambda: _smoke("gemma3-12b"),
    "qwen3-8b-gqa": lambda: _smoke("qwen3-8b", n_kv_heads=2, qkv_bias=True),
}
# the archs the port does not build: all but dense and xLSTM (ssm with
# slstm_every, tests/test_torch_xlstm.py)
NON_DENSE = [a for a in jconfigs.list_archs()
             if jconfigs.get_config(a).arch_type != "dense"
             and not (jconfigs.get_config(a).arch_type == "ssm"
                      and jconfigs.get_config(a).slstm_every)]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


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


def test_configs_and_shapes_match_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.list_archs():
        assert (dataclasses.asdict(tconfigs.get_config(arch))
                == dataclasses.asdict(jconfigs.get_config(arch))), arch
        assert (dataclasses.asdict(tconfigs.get_smoke_config(arch))
                == dataclasses.asdict(jconfigs.get_smoke_config(arch))), arch
        for shape in jshapes.SHAPES:
            assert tshapes.applicable(arch, shape) == jshapes.applicable(arch, shape)
    for name, shape in jshapes.SHAPES.items():
        assert dataclasses.asdict(tshapes.SHAPES[name]) == dataclasses.asdict(shape)
        assert tshapes.shape_settings(tshapes.SHAPES[name]) == jshapes.shape_settings(shape)


def test_param_count_of_the_served_config():
    cfg = tserve.serve_config("qwen3-8b", full=True)
    assert cfg.dtype == "bfloat16" and cfg.n_layers == 36 and cfg.vocab == 151936
    assert cfg.param_count() == jconfigs.get_config("qwen3-8b").param_count()
    model = build_model(dataclasses.replace(cfg, n_layers=1, vocab=8), "cpu")   # uninitialised
    per_layer = sum(p.numel() for p in model.stacks[0].layers[0].parameters())
    total = (per_layer * cfg.n_layers + 2 * cfg.vocab * cfg.d_model + cfg.d_model)
    assert 8.1e9 < total < 8.3e9


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
            for name in ("k", "v"):
                np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                           atol=DECODE_ATOL, rtol=0)


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
    np.testing.assert_array_equal(prompts, jax_markov_tokens(3, jmodel.cfg.vocab, B, PROMPT))
    want = _jax_serve_loop(jmodel, params, prompts, NEW)
    got, _ = tserve.greedy_decode(make_serve_step(tmodel), tmodel.init_cache(B, PROMPT + NEW),
                                  torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", NON_DENSE)
def test_build_model_names_the_slice_of_other_archs(arch):
    item = {"vlm": 7, "moe": 8, "ssm": 9, "hybrid": 9, "encdec": 10, "audio": 10}[
        tconfigs.get_config(arch).arch_type]
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}, the "):
        build_model(tconfigs.get_smoke_config(arch), "cpu")


def test_build_model_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tconfigs.get_smoke_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--batch", "1", "--prompt-len", "2", "--new-tokens", "1"])


def test_training_entry_points_run():
    """``loss``, ``split_params``, ``client_forward`` and ``ap_forward`` run
    (``tests/test_torch_train.py`` holds them against the reference)."""
    cfg = tconfigs.get_smoke_config("qwen3-8b")
    model = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(make_markov_tokens(1, cfg.vocab, B, S + 1))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    loss, metrics = model.loss(batch)
    assert loss.requires_grad and bool(torch.isfinite(loss))
    assert set(metrics) == {"lm_loss", "aux_loss"}
    gamma, phi = model.split_params()
    acts = model.client_forward(gamma, batch)
    assert acts.shape == (B, S, cfg.d_model)
    ap_loss, _ = model.ap_forward(phi, acts, batch)
    assert torch.allclose(ap_loss, loss)


def test_init_is_seeded_and_drawn_as_the_reference_draws():
    cfg = _port_cfg(CASES["qwen3-8b-gqa"]())
    a = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    b = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    layer = a.stacks[0].layers[0]
    assert abs(float(a.embedding.detach().std()) - 0.02) < 1e-3
    assert abs(float(a.head.w.detach().std()) - 0.02) < 2e-3
    bound = 2.0 / cfg.d_model ** 0.5              # truncated at 2 sigma, fan-in scaled
    assert float(layer.attn.wq.w.abs().max()) <= bound
    assert torch.equal(layer.attn.wq.b, torch.zeros_like(layer.attn.wq.b))
    assert torch.equal(layer.ln1.scale, torch.ones_like(layer.ln1.scale))
    assert torch.equal(layer.attn.q_norm.scale, torch.ones_like(layer.attn.q_norm.scale))


def test_serve_cli_on_the_cpu(capsys, tmp_path):
    tserve.main(["--device", "cpu", "--arch", "gemma3-12b", "--batch", "2",
                 "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=gemma3-12b-smoke batch=2 prompt=4 new=3" in out and "(CPU)" in out
    # --trace: a provenance stamp and one span a decode step (prompt + new)
    from repro_torch.telemetry import read_jsonl
    trace = str(tmp_path / "t.jsonl")
    tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
                 "--new-tokens", "3", "--trace", trace])
    assert f"telemetry trace: {trace}" in capsys.readouterr().out
    events = read_jsonl(trace)
    assert events[0]["event"] == "run_start" and "gpus" in events[0]["provenance"]
    spans = [e for e in events if e["event"] == "span"]
    assert [s["call"] for s in spans] == list(range(4 + 3))
    assert {s["name"] for s in spans} == {"serve.decode"}


def test_full_vocab_prompts_are_seeded_without_the_markov_matrix():
    a = tserve.make_prompts(0, 151936, 4, 480)
    assert a.shape == (4, 480) and a.dtype == np.int32 and a.max() < 151936
    np.testing.assert_array_equal(a, tserve.make_prompts(0, 151936, 4, 480))
    np.testing.assert_array_equal(tserve.make_prompts(0, 512, 2, 8),
                                  make_markov_tokens(0, 512, 2, 8))
