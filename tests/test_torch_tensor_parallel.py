"""The port's data and model axes (``models/parallel.py``, the parallel
model of ``launch/mesh.py::make_mesh``) against the reference on the CPU.

The port's runs come from one gloo group a world size (2 and 4 ranks, one
intra-op thread a rank, ``tests/_tp_ranks.py``) at niceness ``NICE``, as
``tests/test_torch_sharded.py``'s.  The reference's are its one-device
``jit`` runs in this process (GSPMD changes the layout, not the function)
and, for the dense_kv2 decode, the heads6 train step and the batch-1
decode, its ``jit`` over an 8-device (2, 4) host mesh with its own
``param_shardings``/``cache_shardings(seq_shard=...)`` as ``in_shardings``,
in a subprocess (``tests/_tp_oracle.py``).

  * the smoke Qwen3-8B over meshes (data 1, model 2), (1, 4) and (2, 2):
    the loss, every gradient, the train step's loss and updated
    parameters, the prefill logits, and the serve loop (8 prompt steps and
    8 greedy tokens over the KV-sharded cache); the loss and logits within
    rtol 1e-5, gradients and parameters within rtol 1e-4 (each of a
    tensor's elements against its largest);
  * the same config with 2 KV heads at model 4: each KV head held whole on
    the two ranks whose query heads read it, its decode cache's sequence
    split between them (B6's partial mode, the partials combined);
  * 6 query heads at model 4 (the attention block whole on each rank, its
    cache split over the four) and a vocab of 513 at (1, 4) and (2, 2) (the
    embedding and the head whole): the same checks, and a planted sum over
    ``model`` of the whole attention's gradients fails the gradient check;
  * batch-1 serve loops at (4, 1) and, with one KV head, (2, 2): the
    cache's sequence over the data ranks (and the model ranks), every rank
    holding the row: tokens equal, logits within rtol 1e-5;
  * the smoke Qwen3-30B-A3B with ``moe_shard`` (T = 64 = 16 E: the
    shard-local dispatch) at (1, 2), (1, 4) and (2, 2), experts over
    ``model``, whole groups a data rank, the same way;
  * ``_moe_forward_local_dispatch`` on one device against the reference's,
    at a batch that takes it and one that does not: routing ids and kept
    pairs exactly, outputs within rtol 1e-5;
  * the round step over (pod 2, data 1, model 2) on 4 ranks against the
    reference's ``make_pigeon_round_step`` (vmap) on the same inits:
    ``sel`` exactly, vlosses within rtol 1e-5;
  * a group of one's parallel model bit-equal to the plain model.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _tp_ranks as ranks
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe
from _torch_threads import one_thread  # noqa: F401

DEADLINE_S = 300.0
NICE = 10
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
LM_CASES = [(case, rest[0]) for world in ranks.WORLDS for case, *rest in ranks.WORLDS[world]
            if case not in ("round", "decode1")]
ROUND_CASES = [tuple(rest) for world in ranks.WORLDS for case, *rest in ranks.WORLDS[world]
               if case == "round"]
DECODE1_CASES = [tuple(rest) for world in ranks.WORLDS for case, *rest in ranks.WORLDS[world]
                 if case == "decode1"]
ORACLE_DIR = os.path.dirname(os.path.abspath(__file__))


def _jcfg(case):
    arch, over, opts = ranks.ARCHS[case]
    return dataclasses.replace(jconfigs.get_smoke_config(arch), optimizations=opts, **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, what):
    """Each element within ``rtol`` of the tensor's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


def _serve_loop(jm, params, prompts, new, memory=None):
    cache = jm.init_cache(prompts.shape[0], prompts.shape[1] + new)
    step = jax.jit(jm.decode_step)
    for i in range(prompts.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(prompts[:, i:i + 1]), i, memory)
    prompt_logits = np.asarray(logits)
    out = []
    for j in range(new):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
        logits, cache = step(params, cache, tok, prompts.shape[1] + j, memory)
    return np.concatenate(out, axis=1), prompt_logits


def _reference_lm(case):
    """The reference's init, batch and one-device results for ``case``."""
    cfg = _jcfg(case)
    jm = jbuild_model(cfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(7)
    batch = {k: rng.integers(0, cfg.vocab, (ranks.B, ranks.S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.arch_type in ("encdec", "audio"):
        batch["frames"] = rng.normal(size=(ranks.B, ranks.FRAMES, cfg.d_model)
                                     ).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    inputs = dict(batch=batch)
    # moe_shard's constraints need an ambient mesh: one device's
    with Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model")):
        (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jb)
        updated, step_loss = jax.jit(jsteps.make_train_step(jm, ranks.LR))(params, jb)
        prefill = jax.jit(jsteps.make_prefill_step(jm))(params, jb)
        memory = None
        if "frames" in batch:       # the serve loop reads the encoder's memory of the frames
            memory = jax.jit(jm.encode)(params, jb)
            inputs["memory"] = np.asarray(memory)
        tokens, prompt_logits = _serve_loop(jm, params, batch["tokens"][:, :ranks.PROMPT],
                                            ranks.NEW, memory)
    want = dict(loss=float(loss), grads=_np(grads), step_loss=float(step_loss),
                updated=_np(updated), prefill=np.asarray(prefill), tokens=tokens,
                prompt_logits=prompt_logits)
    return dict(params=_np(params), **inputs), want


def _reference_decode1(case):
    """The reference's init, prompt and one-device batch-1 serve loop."""
    jm = jbuild_model(_jcfg(case))
    params = jax.jit(jm.init)(jax.random.PRNGKey(5))
    prompt = np.random.default_rng(11).integers(0, _jcfg(case).vocab, (1, ranks.PROMPT)
                                                ).astype(np.int32)
    tokens, prompt_logits = _serve_loop(jm, params, prompt, ranks.NEW)
    return dict(params=_np(params), prompt=prompt), dict(tokens=tokens,
                                                         prompt_logits=prompt_logits)


def _reference_round(case):
    cfg = _jcfg(case)
    jm = jbuild_model(cfg)
    trees = [_np(jax.jit(jm.init)(jax.random.PRNGKey(s))) for s in (0, 1)]
    rng = np.random.default_rng(9)
    batches = {k: rng.integers(0, cfg.vocab, (2, 4, ranks.S)).astype(np.int32)
               for k in ("tokens", "labels")}
    val = {k: rng.integers(0, cfg.vocab, (4, ranks.S)).astype(np.int32)
           for k in ("tokens", "labels")}
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    new, vl, sel = jax.jit(jsteps.make_pigeon_round_step(jm, ranks.LR))(
        stacked, {k: jnp.asarray(v) for k, v in batches.items()},
        {k: jnp.asarray(v) for k, v in val.items()})
    want = dict(vlosses=np.asarray(vl), sel=np.asarray(sel),
                slot0=jax.tree.map(lambda x: np.asarray(x[0]), new))
    return dict(trees=trees, batches=batches, val=val), want


@pytest.fixture(scope="module")
def reference():
    """(inputs, want): the reference's one-device runs of every case."""
    inputs, want = {}, {}
    for case in sorted({case for case, _ in LM_CASES}):
        inputs[case], want[case] = _reference_lm(case)
    for case, _ in DECODE1_CASES:
        inputs[("decode1", case)], want[("decode1", case)] = _reference_decode1(case)
    for case, _ in ROUND_CASES:
        inputs[("round", case)], want[("round", case)] = _reference_round(case)
    return inputs, want


@pytest.fixture(scope="module")
def runs(reference):
    """(reference, port {world: [rank results]}): the reference's runs,
    then the port's two groups one after the other."""
    from repro_torch.launch.mesh import spawn
    inputs, want = reference
    port = {w: spawn(ranks.run_world, w, "gloo", DEADLINE_S, args=(w, inputs, NICE),
                     threads=1)
            for w in ranks.WORLDS}
    return want, port


@pytest.fixture(scope="module")
def oracle(reference, runs, tmp_path_factory):
    """The reference's runs over an 8-device host mesh (``_tp_oracle.py``),
    in a subprocess after the port's groups, so one of them loads the CPU
    at a time."""
    import _tp_oracle
    inputs, _ = reference
    out_dir = tmp_path_factory.mktemp("tp_oracle")
    path, result = str(out_dir / "inputs.pkl"), str(out_dir / "oracle.pkl")
    feed = {"dense_kv2": dict(params=inputs["dense_kv2"]["params"],
                              prompts=inputs["dense_kv2"]["batch"]["tokens"][:, :ranks.PROMPT],
                              new=ranks.NEW),
            "heads6": dict(params=inputs["heads6"]["params"], batch=inputs["heads6"]["batch"]),
            "decode1": dict(params=inputs[("decode1", "dense")]["params"],
                            prompts=inputs[("decode1", "dense")]["prompt"], new=ranks.NEW),
            "mla": dict(params=inputs["mla"]["params"],
                        prompts=inputs["mla"]["batch"]["tokens"][:, :ranks.PROMPT],
                        new=ranks.NEW),
            "zamba2": dict(params=inputs["zamba2"]["params"], batch=inputs["zamba2"]["batch"]),
            "xlstm": dict(params=inputs["xlstm"]["params"], batch=inputs["xlstm"]["batch"])}
    assert set(feed) == set(_tp_oracle.CASES)
    with open(path, "wb") as f:
        pickle.dump(feed, f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(os.path.dirname(ORACLE_DIR), "src"),
                                           os.environ.get("PYTHONPATH", "")]),
               XLA_FLAGS=(flags + " --xla_force_host_platform_device_count=8").strip())
    done = subprocess.run(["nice", "-n", str(NICE), sys.executable,
                           os.path.join(ORACLE_DIR, "_tp_oracle.py"), path, result],
                          env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=DEADLINE_S)
    assert done.returncode == 0, done.stdout
    with open(result, "rb") as f:
        return pickle.load(f)


def _results(port, case, *key):
    world = next(w for w, cases in ranks.WORLDS.items() if (case, *key) in cases)
    return [r[(case, *key)] for r in port[world]]


def _kv_layout(cfg, m):
    """(KV heads a rank's cache holds, model ranks that split its sequence):
    its own share, a KV head shared by m / Hkv ranks, or the whole block's
    every KV head over all m; MLA's latent (no head axis) over all m."""
    if cfg.kv_lora_rank:
        return None, m
    if cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0:
        return cfg.n_kv_heads // m, 1
    if cfg.n_heads % m == 0 and m % cfg.n_kv_heads == 0:
        return 1, m // cfg.n_kv_heads
    return cfg.n_kv_heads, m


def _split(n, m):
    """A dim of n over a model axis of m: split where m divides it."""
    return n // m if n % m == 0 and n >= m else n


def _cache_shapes(case, dims, batch, max_seq):
    """{"stack/name": shape} of a rank's decode cache at (data, model) =
    ``dims``: the rows over ``data`` (all of them where the panels span the
    data ranks: a batch of 1), an attention cache's sequence over its
    panels and its heads as :func:`_kv_layout` gives them, Mamba2's and the
    mLSTM's heads over ``model`` where it divides them (Mamba2's
    convolution holds the rank's x channels and the whole B and C), the
    sLSTM's state whole."""
    from repro_torch.models.model import build_plan
    cfg = _jcfg(case)
    data, m = dims
    plan = build_plan(cfg)
    heads, share = _kv_layout(cfg, m)
    if all(sp.kind in ("mamba", "mlstm", "slstm") for sp in plan):
        share = 1                         # no attention cache: no panels
    panels = share * (data if batch == 1 else 1)
    rows = batch if batch == 1 else batch // data
    seq = -(-max_seq // panels)
    hd = cfg.resolved_head_dim
    out = {}
    for i, sp in enumerate(plan):
        lead = () if sp.kind == "shared_attn" else (sp.n,)
        if sp.kind == "mamba":
            di, st = 2 * cfg.d_model, cfg.ssm_state
            h = _split(di // 64, m)
            out.update({f"{i}/state": lead + (rows, h, 64, st),
                        f"{i}/conv": lead + (rows, 3, h * 64 + 2 * st)})
        elif sp.kind == "mlstm":
            h = _split(cfg.n_heads, m)
            d = 2 * cfg.d_model // cfg.n_heads
            out.update({f"{i}/C": lead + (rows, h, d, d), f"{i}/n": lead + (rows, h, d),
                        f"{i}/m": lead + (rows, h)})
        elif sp.kind == "slstm":
            out.update({f"{i}/{k}": lead + (rows, cfg.d_model) for k in ("c", "n", "h", "m")})
        elif cfg.kv_lora_rank:
            out.update({f"{i}/latent": lead + (rows, seq, cfg.kv_lora_rank),
                        f"{i}/k_rope": lead + (rows, seq, cfg.rope_dim)})
        else:
            out.update({f"{i}/{k}": lead + (rows, seq, heads, hd) for k in ("k", "v")})
    return out, panels


def _assert_tree(got, want, rtol, what):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        _close(a, b, rtol, f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("case,dims", LM_CASES)
def test_loss_gradients_and_step_match_reference(runs, case, dims):
    want, port = runs
    w = want[case]
    for rank, got in enumerate(_results(port, case, dims)):
        what = f"{case} {dims} rank {rank}"
        _close(got["loss"], w["loss"], LOSS_RTOL, what + " loss")
        _close(got["step_loss"], w["step_loss"], LOSS_RTOL, what + " step loss")
        _assert_tree(got["grads"], w["grads"], GRAD_RTOL, what + " grad")
        _assert_tree(got["updated"], w["updated"], GRAD_RTOL, what + " updated")


@pytest.mark.parametrize("case,dims", LM_CASES)
def test_prefill_and_serve_loop_match_reference(runs, case, dims):
    want, port = runs
    w = want[case]
    for rank, got in enumerate(_results(port, case, dims)):
        what = f"{case} {dims} rank {rank}"
        _close(got["prefill"], w["prefill"], LOSS_RTOL, what + " prefill")
        _close(got["prompt_logits"], w["prompt_logits"], LOSS_RTOL, what + " decode")
        np.testing.assert_array_equal(got["tokens"], w["tokens"], err_msg=what)
        shapes, panels = _cache_shapes(case, dims, ranks.B, ranks.PROMPT + ranks.NEW)
        assert (got["cache_shapes"], got["panels"]) == (shapes, panels), what


@pytest.mark.parametrize("case,dims", DECODE1_CASES)
def test_batch_one_decode_over_the_data_ranks_matches_reference(runs, case, dims):
    """A batch-1 cache: its sequence over the data ranks too (the
    reference's seq_shard layout), every data rank holding the row."""
    want, port = runs
    w = want[("decode1", case)]
    shapes, panels = _cache_shapes(case, dims, 1, ranks.PROMPT + ranks.NEW)
    for rank, got in enumerate(_results(port, "decode1", case, dims)):
        what = f"decode1 {case} {dims} rank {rank}"
        assert got["rows_whole"] and got["panels"] == panels, what
        assert got["cache_shape"] == next(iter(shapes.values())), what
        _close(got["prompt_logits"], w["prompt_logits"], LOSS_RTOL, what + " decode")
        np.testing.assert_array_equal(got["tokens"], w["tokens"], err_msg=what)


def test_planted_model_sum_of_a_whole_attention_gradient_is_caught(runs):
    """The whole attention block's gradient summed over ``model`` (what
    treating its replicated weights as shards would do) fails the gradient
    comparison that the sound gradient passes."""
    want, port = runs
    for rank, got in enumerate(_results(port, "heads6", (1, 4))):
        _assert_tree(got["grads"], want["heads6"]["grads"], GRAD_RTOL, f"rank {rank} grad")
        with pytest.raises(AssertionError):
            _assert_tree(got["planted_grads"], want["heads6"]["grads"], GRAD_RTOL,
                         f"rank {rank} planted grad")


def test_planted_unreduced_out_norm_is_caught(runs):
    """Mamba2's ``out_norm`` with each rank's sum of squares left unreduced
    over ``model`` (each normalising by its own heads' mean) fails the
    gradient and the prefill comparisons that the sound run passes."""
    want, port = runs
    case, dims = ranks.NORM_FAULT
    w = want[case]
    for rank, got in enumerate(_results(port, case, dims)):
        _assert_tree(got["grads"], w["grads"], GRAD_RTOL, f"rank {rank} grad")
        _close(got["prefill"], w["prefill"], LOSS_RTOL, f"rank {rank} prefill")
        with pytest.raises(AssertionError):
            _assert_tree(got["planted_norm_grads"], w["grads"], GRAD_RTOL,
                         f"rank {rank} planted grad")
        with pytest.raises(AssertionError):
            _close(got["planted_norm_prefill"], w["prefill"], LOSS_RTOL,
                   f"rank {rank} planted prefill")


#: oracle case -> (the port's results it is held against, the spec entry
#: that shows the reference's layout: (leaf, dim, axis))
ORACLE_CASES = {
    "dense_kv2": (("dense_kv2", (1, 4)), ("cache_specs", "0/k", 2, "model")),
    # 384 columns over 4: 1.5 heads a rank
    "heads6": (("heads6", (1, 4)), ("param_specs", "stacks/0/attn/wq/w", -1, "model")),
    "decode1": (("decode1", "dense", (4, 1)), ("cache_specs", "0/k", 2, "data")),
    # the latent's sequence over model
    "mla": (("mla", (1, 4)), ("cache_specs", "1/latent", 2, "model")),
    # in_proj's 1,096 columns cut straight across [z, x, B, C, dt]
    "zamba2": (("zamba2", (1, 4)), ("param_specs", "stacks/0/mixer/in_proj/w", -1, "model")),
    # up's columns cut across [x_inner, z]
    "xlstm": (("xlstm", (1, 4)), ("param_specs", "stacks/0/mixer/up/w", -1, "model")),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_reference_over_an_eight_device_mesh_matches_the_port(runs, oracle, case):
    """The reference's jit over a (2, 4) host mesh with its own shardings:
    the dense_kv2 and MLA serve loops (their caches' sequence over
    ``model``), the heads6 train step (``wq`` split inside a head), the
    batch-1 serve loop (its cache's sequence over ``data``), the Zamba2 and
    xLSTM train steps (``in_proj`` and ``up`` cut across their sections)
    against the port's ranks."""
    want, port = runs
    key, (specs, leaf, dim, axis) = ORACLE_CASES[case]
    got_all = _results(port, *key)
    o = oracle[case]
    assert o[specs][leaf][dim] == axis
    for rank, got in enumerate(got_all):
        what = f"{case} rank {rank} against the 8-device reference"
        if "loss" in o:
            _close(got["loss"], o["loss"], LOSS_RTOL, what + " loss")
            _close(got["step_loss"], o["step_loss"], LOSS_RTOL, what + " step loss")
            _assert_tree(got["grads"], o["grads"], GRAD_RTOL, what + " grad")
            _assert_tree(got["updated"], o["updated"], GRAD_RTOL, what + " updated")
        else:
            _close(got["prompt_logits"], o["prompt_logits"], LOSS_RTOL, what + " decode")
            np.testing.assert_array_equal(got["tokens"], o["tokens"], err_msg=what)


@pytest.mark.parametrize("case,dims", ROUND_CASES)
def test_round_step_over_pod_data_model_matches_reference(runs, case, dims):
    """The round step over (pod 2, data 1, model 2): the dense stack and
    the stacked MLA and MoE, Mamba2 and shared block, mLSTM and sLSTM, a
    slot a pod, each slot's model parallel over its 2 model ranks."""
    want, port = runs
    w = want[("round", case)]
    for got in _results(port, "round", case, dims):
        assert got["sel"].tolist() == w["sel"].tolist(), got["rank"]
        _close(got["vlosses"], w["vlosses"], LOSS_RTOL, f"rank {got['rank']} vlosses")
        _assert_tree(got["slot0"], w["slot0"], GRAD_RTOL, f"rank {got['rank']} winner")


def _local_dispatch_pair(t_tokens, **kw):
    jcfg = jmoe.MoEConfig(**{**dict(d_model=32, d_expert=16, n_experts=4, top_k=2,
                                    shard_groups=16), **kw})
    p = jmoe.moe_init(jax.random.PRNGKey(2), jcfg)
    w = tmoe.MoEWeights(*(torch.from_numpy(np.array(p[n]))
                          for n in ("router", "gate", "up", "down")))
    x = np.random.default_rng(t_tokens).normal(size=(t_tokens // 16, 16, 32)).astype(np.float32)
    return jcfg, tmoe.MoEConfig(**{**jcfg._asdict(), "shard": True}), p, w, x


@pytest.mark.parametrize("t_tokens,cf", [(64, 1.25), (512, 0.25), (32, 1.25)])
def test_local_dispatch_matches_reference(t_tokens, cf):
    """The 16-group dispatch where T >= 16 E (and with a tight capacity),
    the global one where T < 16 E: ids and kept pairs exactly, outputs
    within rtol 1e-5."""
    jcfg, tcfg, p, w, x = _local_dispatch_pair(t_tokens, capacity_factor=cf)
    taken = tmoe.local_dispatch_taken(tcfg, t_tokens)
    assert taken == (t_tokens >= 16 * 4)
    jids = np.asarray(jmoe.route(p, jcfg, jnp.asarray(x.reshape(-1, 32)))[1])
    _, tids, _ = tmoe.route(w.router, tcfg, torch.from_numpy(x).reshape(-1, 32))
    np.testing.assert_array_equal(tids.numpy(), jids)
    groups = 16 if taken else 1
    cap = tmoe.capacity(t_tokens // groups, tcfg)
    _, keep = tmoe.dispatch_groups(tids, tcfg, groups, cap)
    flat = jids.reshape(groups, -1)
    onehot = np.eye(4, dtype=np.int64)[flat]
    slot = np.take_along_axis(np.cumsum(onehot, axis=1) - 1, flat[..., None], 2)[..., 0]
    np.testing.assert_array_equal(keep.numpy(), slot < cap)
    if cf < 1:
        assert (slot >= cap).any()
    if taken:
        jout, _ = jmoe._moe_forward_local_dispatch(p, jcfg, jnp.asarray(x))
    else:
        jout, _ = jmoe.moe_forward(p, jcfg, jnp.asarray(x))
    tout, _ = tmoe.moe_forward(w, tcfg, torch.from_numpy(x))
    _close(tout.numpy(), np.asarray(jout), LOSS_RTOL, "moe out")


def test_group_of_one_is_bit_equal_to_the_plain_model():
    """A (1, 1) mesh's parallel model: loss, gradients, prefill and decode
    logits bit for bit the plain model's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import group_of_one, make_mesh
    from repro_torch.launch.shardings import shard_params
    from repro_torch.models import build_model
    cfg = get_smoke_config("qwen3-8b")
    plain = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    batch = {k: torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(i))
             for i, k in enumerate(("tokens", "labels"))}
    with group_of_one("gloo"):
        par_model = shard_params(build_model(cfg, "cpu", make_mesh((1, 1), ("data", "model"))),
                                 dict(plain.named_parameters()))
        for m in (plain, par_model):
            loss, _ = m.loss(batch)
            m.grads = torch.autograd.grad(loss, list(m.parameters()))
            m.out = (loss.detach(), steps.make_prefill_step(m)(batch),
                     steps.make_serve_step(m)(m.init_cache(2, 4), batch["tokens"][:, :1], 0)[0])
    for a, b in zip(plain.grads + plain.out, par_model.grads + par_model.out):
        assert torch.equal(a, b)
