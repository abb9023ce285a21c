"""Parity of the batched round's building blocks with the JAX reference and
with the port's own sequential pieces: the cluster-stacked split CNN, the
AttackVec transforms, the masked acceptance cascade and the policies.

Floats: the stacked CNN agrees with R plain modules at rtol 1e-5 / atol
5e-6: grouped convolutions and batched products sum in other orders than the
plain ones, and CIFAR's cut layer sums 2,048 products of O(1) terms, whose
f32 rounding reaches ~1e-6 absolute where the sum cancels towards 0.
Gradients, which pass through one more such sum, agree at rtol 1e-4.
Honest AttackVec slots, the deterministic families and the cascade are
bit-exact."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.selection as jsel
from repro.adversary import registry as jreg
from repro.adversary.specs import Attack as JAttack
from repro.core import from_cnn as jax_from_cnn
from repro.core.runner import masked_argmin as jax_masked_argmin
from repro.core.runner import policy_scores as jax_policy_scores
from repro.core.split import sl_minibatch_grads
from repro.models import cnn as jcnn
from repro_torch.adversary import registry as treg
from repro_torch.adversary import specs as tspecs
from repro_torch.convert import (from_reference, slot_to_reference,
                                 stack_reference)
from repro_torch.core import protocol as tprotocol
from repro_torch.core import runner as trunner
from repro_torch.core import split as tsplit
from repro_torch.models import cnn as tcnn
import repro_torch.selection as tsel
from _torch_threads import one_thread  # noqa: F401

importlib.import_module("repro.adversary.families")      # populate the registry
RTOL, ATOL = 1e-5, 5e-6
R = 3
# one compiled program per case instead of op-by-op dispatch (fast tier)
jax_grads = jax.jit(sl_minibatch_grads, static_argnums=(0, 1))
CONFIGS = {"mnist": (jcnn.MNIST_CNN, tcnn.MNIST_CNN),
           "cifar": (jcnn.CIFAR_CNN, tcnn.CIFAR_CNN)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def stacked(request):
    """R different reference parameter sets, converted plain and stacked,
    with (R, B, ...) seeded inputs."""
    jcfg, tcfg = CONFIGS[request.param]
    init = jax.jit(jcnn.cnn_init, static_argnums=1)
    trees = [_np_tree(init(jax.random.PRNGKey(10 + r), jcfg)) for r in range(R)]
    plain = [from_reference(tcfg, g, p) for g, p in trees]
    sg, sp = stack_reference(tcfg, trees)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(R, 4, tcfg.image_size, tcfg.image_size,
                         tcfg.in_channels)).astype(np.float32)
    y = rng.integers(0, 10, size=(R, 4)).astype(np.int32)
    return tcfg, trees, plain, (sg, sp), x, y


def test_stack_and_slot_round_trip_is_exact(stacked):
    cfg, trees, _, (sg, sp), _, _ = stacked
    for r, (g, p) in enumerate(trees):
        g2, p2 = slot_to_reference(cfg, sg, sp, r)
        for a, b in zip(jax.tree.leaves((g, p)), jax.tree.leaves((g2, p2))):
            np.testing.assert_array_equal(a, b)


def test_stacked_forward_matches_plain_modules(stacked):
    cfg, _, plain, (sg, sp), x, _ = stacked
    module = tsplit.from_cnn(cfg)
    with torch.no_grad():
        acts = module.stacked.client_forward(sg, torch.from_numpy(x))
        logits = sp(acts)
        for r, (g, p) in enumerate(plain):
            a_r = module.client_forward(g, torch.from_numpy(x[r]))
            np.testing.assert_allclose(acts[r].numpy(), a_r.numpy(), rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(logits[r].numpy(), p(a_r).numpy(),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_stacked_exchange_gives_each_cluster_its_own_gradients(stacked, quant):
    """The AP differentiates the sum of the per-cluster losses: each slot's
    gradients equal the plain exchange of that cluster alone, and the
    per-cluster losses and stats come out per slot."""
    cfg, _, plain, (sg, sp), x, y = stacked
    module = tsplit.from_cnn(cfg)
    av = treg.attack_vec_grid([[tspecs.HONEST]] * R).client(0)
    gg, gp, loss, st = tsplit.sl_minibatch_grads_vec(
        module, av, sg, sp, torch.from_numpy(x), torch.from_numpy(y), None,
        with_stats=True, quant=quant)
    assert loss.shape == (R,) and st.shape == (R, 2)
    for r, (g, p) in enumerate(plain):
        g_r, p_r, l_r, st_r = tsplit.sl_minibatch_grads(
            module, tspecs.HONEST, g, p, torch.from_numpy(x[r]),
            torch.from_numpy(y[r]), None, with_stats=True, quant=quant)
        np.testing.assert_allclose(float(loss[r]), float(l_r), rtol=RTOL)
        np.testing.assert_allclose(st[r].numpy(), st_r.numpy(), rtol=1e-4, atol=ATOL)
        for big, small in zip(gg + gp, g_r + p_r):
            np.testing.assert_allclose(big[r].numpy(), small.numpy(),
                                       rtol=1e-4, atol=ATOL)


def test_stacked_exchange_matches_reference(stacked):
    """Slots of the stack against the JAX exchange on their reference
    parameters: losses and the AP-side (dense, same layout) gradients."""
    cfg, trees, _, (sg, sp), x, y = stacked
    jmod = jax_from_cnn(jcnn.MNIST_CNN if cfg.name == "mnist_cnn" else jcnn.CIFAR_CNN)
    av = treg.attack_vec_grid([[tspecs.HONEST]] * R).client(0)
    _, gp, loss = tsplit.sl_minibatch_grads_vec(
        tsplit.from_cnn(cfg), av, sg, sp, torch.from_numpy(x), torch.from_numpy(y), None)
    for r in (0, R - 1):
        _, p_j, l_j = jax_grads(jmod, JAttack(), *trees[r], jnp.asarray(x[r]),
                                jnp.asarray(y[r]), jax.random.PRNGKey(0))
        np.testing.assert_allclose(float(loss[r]), float(l_j), rtol=RTOL)
        want = [np.asarray(fc[k]) for fc in p_j["fcs"] for k in ("w", "b")]
        for a, b in zip(gp, want, strict=True):
            np.testing.assert_allclose(a[r].numpy(), b, rtol=1e-4, atol=ATOL)


# ---------------------------------------------------------------------------
# AttackVec
# ---------------------------------------------------------------------------

DETERMINISTIC = {
    "label_flip": dict(label_shift=3),
    "gradient": dict(),
    "grad_scale": dict(grad_scale=8.0),
    "backdoor": dict(target=7, trigger_frac=0.1, trigger_value=2.0),
    "replay": dict(),
}
SLOTS = (True, False, True, False)       # malicious / honest per cluster slot


def _lanes(mod, attack, specs_mod):
    grid = [[attack if on else specs_mod.HONEST] for on in SLOTS]
    return mod.attack_vec_grid(grid)


def _messages():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(len(SLOTS), 6, 4, 4, 2)).astype(np.float32)
    y = rng.integers(0, 10, size=(len(SLOTS), 6)).astype(np.int32)
    acts = np.maximum(rng.normal(size=(len(SLOTS), 6, 16)), 0).astype(np.float32)
    g = rng.normal(size=(len(SLOTS), 6, 16)).astype(np.float32)
    noise = rng.normal(size=(len(SLOTS), 6, 16)).astype(np.float32)
    return x, y, acts, g, noise


def _port_vec(av, x, y, acts, g, noise):
    t = torch.from_numpy
    return (treg.poison_inputs_vec(av, t(x)), treg.flip_labels_vec(av, t(y), 10),
            treg.tamper_activation_vec(av, t(acts), t(noise)),
            treg.tamper_gradient_vec(av, t(g), t(noise)))


@pytest.mark.parametrize("kind", sorted(DETERMINISTIC))
def test_attack_vec_matches_reference_vec_and_port_static(kind):
    x, y, acts, g, noise = _messages()
    ja = JAttack(kind, **DETERMINISTIC[kind])
    ta = tspecs.Attack(kind, **DETERMINISTIC[kind])
    av = _lanes(treg, ta, tspecs).client(0)
    jav = jax.tree.map(lambda a: a[:, 0], _lanes(jreg, ja, jreg))
    key = jax.random.PRNGKey(0)
    want = jax.vmap(lambda v, x_, y_, a_, g_: (
        jreg.poison_inputs_vec(v, x_), jreg.flip_labels_vec(v, y_, 10),
        jreg.tamper_activation_vec(v, a_, key), jreg.tamper_gradient_vec(v, g_, key)))(
        jav, jnp.asarray(x), jnp.asarray(y), jnp.asarray(acts), jnp.asarray(g))
    got = _port_vec(av, x, y, acts, g, noise)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t = torch.from_numpy
    for r, on in enumerate(SLOTS):
        spec = ta if on else tspecs.HONEST
        static = (treg.poison_inputs(spec, t(x[r])), treg.flip_labels(spec, t(y[r]), 10),
                  treg.tamper_activation(spec, t(acts[r]), None),
                  treg.tamper_gradient(spec, t(g[r]), None))
        for a, b in zip(got, static):
            assert torch.equal(a[r], b), (kind, r)


@pytest.mark.parametrize("kind", ["activation", "grad_noise"])
def test_stochastic_attack_vec_matches_port_static(kind):
    """The same noise through the vec and static hooks: attacked slots
    agree to f32 rounding, honest slots are untouched bit for bit."""
    x, y, acts, g, noise = _messages()
    ta = tspecs.Attack(kind)
    av = _lanes(treg, ta, tspecs).client(0)
    _, _, a_vec, g_vec = _port_vec(av, x, y, acts, g, noise)
    t = torch.from_numpy
    for r, on in enumerate(SLOTS):
        spec = ta if on else tspecs.HONEST
        a_st = treg.tamper_activation(spec, t(acts[r]), t(noise[r]))
        g_st = treg.tamper_gradient(spec, t(g[r]), t(noise[r]))
        if on:
            np.testing.assert_allclose(a_vec[r].numpy(), a_st.numpy(), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(g_vec[r].numpy(), g_st.numpy(), rtol=1e-6, atol=1e-7)
        else:
            assert torch.equal(a_vec[r], t(acts[r])) and torch.equal(g_vec[r], t(g[r]))


def test_attack_vec_generators_draw_only_for_their_slots():
    """Per-slot generators: an attacked slot draws exactly what the static
    hook draws from a generator seeded alike; honest slots draw nothing."""
    _, _, acts, _, _ = _messages()
    ta = tspecs.Attack("activation")
    av = _lanes(treg, ta, tspecs).client(0)
    gens = [torch.Generator().manual_seed(100 + r) for r in range(len(SLOTS))]
    out = treg.tamper_activation_vec(av, torch.from_numpy(acts), gens)
    for r, on in enumerate(SLOTS):
        fresh = torch.Generator().manual_seed(100 + r)
        if on:
            st = treg.tamper_activation(ta, torch.from_numpy(acts[r]), fresh)
            np.testing.assert_allclose(out[r].numpy(), st.numpy(), rtol=1e-6, atol=1e-7)
        else:                                  # untouched generator state
            assert torch.equal(gens[r].get_state(), fresh.get_state())


def test_attack_vec_lanes_match_reference():
    grid_t = [[tspecs.Attack("label_flip"), tspecs.HONEST],
              [tspecs.Attack("param_tamper"), tspecs.stealth(0.9)]]
    grid_j = [[JAttack("label_flip"), JAttack()],
              [JAttack("param_tamper"), JAttack("stealth", act_keep=0.9)]]
    tv, jv = treg.attack_vec_grid(grid_t), jreg.attack_vec_grid(grid_j)
    assert treg.attack_vec_grid(grid_t) is tv          # memoised
    for name in treg.LANES:
        np.testing.assert_array_equal(getattr(tv, name).numpy(),
                                      np.asarray(getattr(jv, name)))
    np.testing.assert_array_equal(tv.host_code, tv.code.numpy())
    assert tv.client(1).code.tolist() == [0, treg.CODE_ACTIVATION]
    assert treg.attack_vec(tspecs.Attack("label_flip"),
                           [True, False]).code.tolist() == [1, 0]


# ---------------------------------------------------------------------------
# the masked cascade, the policies, the runner's refusals
# ---------------------------------------------------------------------------

def _cascade_cases():
    rng = np.random.default_rng(0)
    for i in range(40):
        r = int(rng.integers(2, 7))
        scores = rng.integers(0, 4, size=r).astype(np.float32)   # many ties
        elig = rng.random(r) < 0.6
        passed = rng.random(r) < 0.5
        if i % 10 == 0:
            elig[:] = False                                      # all ineligible
        if i % 7 == 0:
            passed[:] = False                                    # all fail
        yield scores, elig, passed


def test_masked_first_accept_matches_reference_exactly():
    for scores, elig, passed in _cascade_cases():
        if elig.any():
            assert int(trunner.masked_argmin(torch.from_numpy(scores),
                                             torch.from_numpy(elig))) == \
                int(jax_masked_argmin(jnp.asarray(scores), jnp.asarray(elig)))
        js, jd, ja = jsel.masked_first_accept(jnp.asarray(scores), jnp.asarray(elig),
                                              jnp.asarray(passed))
        ts, td, ta = tsel.masked_first_accept(torch.from_numpy(scores),
                                              torch.from_numpy(elig),
                                              torch.from_numpy(passed))
        assert (int(ts), int(td), bool(ta)) == (int(js), int(jd), bool(ja)), \
            (scores, elig, passed)
        fetch = tsel.pack_fetch(torch.ones(len(scores)), torch.zeros(len(scores)),
                                ts, td, ta)
        np.testing.assert_array_equal(
            fetch.numpy(), np.asarray(jsel.pack_fetch(jnp.ones(len(scores)),
                                                      jnp.zeros(len(scores)), js, jd, ja)))
        assert tsel.unpack_fetch(fetch.numpy(), len(scores))[2:] == (int(js), int(jd), bool(ja))


@pytest.mark.parametrize("seed", range(3))
def test_median_of_means_and_policy_scores_match_reference(seed):
    rng = np.random.default_rng(seed)
    vl = rng.normal(2.3, 0.05, size=5).astype(np.float32)
    shards = rng.normal(2.3, 0.1, size=(5, 4)).astype(np.float32)
    st = np.abs(rng.normal(1.0, 0.3, size=(5, 4, 2))).astype(np.float32)
    for name in ("argmin", "median_of_means", "trimmed", "loss_plus_distance"):
        jp, tp = jsel.resolve_policy(name), tsel.resolve_policy(name)
        assert jp.shard_count == tp.shard_count
        jctx = jsel.ScoreContext(vlosses=jnp.asarray(vl), shard_losses=jnp.asarray(shards),
                                 message_stats=jnp.asarray(st))
        tctx = tsel.ScoreContext(vlosses=torch.from_numpy(vl),
                                 shard_losses=torch.from_numpy(shards),
                                 message_stats=torch.from_numpy(st))
        ts, te = trunner.policy_scores(tp, tctx)
        js, je = jax_policy_scores(jp, jctx)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert tsel.effective_shards(4, 60) == jsel.effective_shards(4, 60) == 4
    assert tsel.effective_shards(4, 7) == jsel.effective_shards(4, 7) == 1


def test_runner_refuses_unported_entries():
    """The sharded placement passes the knob check in a process group (and
    raises without one), and its ``accept_block`` in a group of one equals
    the vmap placement's; the layouts each entry refuses raise."""
    from repro_torch.launch.mesh import group_of_one
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tprotocol._check_engine("batched", placement="sharded")
    with group_of_one("gloo"):
        tprotocol._check_engine("batched", placement="sharded")
    with pytest.raises(ValueError):
        tprotocol._check_engine("batched", placement="mesh")
    # round and round_block run (tests/test_torch_lm_steps.py); each
    # refuses the layout it does not take
    spec = trunner.RoundSpec(train_cluster=None, validate=None)
    with pytest.raises(ValueError, match="params_stacked=True"):
        trunner.RoundRunner(spec).round_block(None, [None], None)
    with pytest.raises(ValueError, match="protocol layout"):
        trunner.RoundRunner(spec, params_stacked=True).accept(None, None, None)

    # accept_block runs: K accepts in turn, their fetches stacked
    class Stacked(torch.nn.Module):
        def __init__(self, w):
            super().__init__()
            self.w = torch.nn.Parameter(w)

    def train(params, shifts):
        return (Stacked(params[0].weight.detach()[None] + shifts[:, None, None]),), shifts

    def validate(new_p, val):
        return (new_p[0].w ** 2).sum(dim=(1, 2)), None

    runner = trunner.RoundRunner(trunner.RoundSpec(train, validate),
                                 verify=trunner.VerifyConfig(enabled=False))
    block = [torch.tensor([0.5, -1.0, 2.0]), torch.tensor([1.0, -0.25, 3.0])]
    theta = (torch.nn.Linear(2, 1, bias=False),)
    with torch.no_grad():
        theta[0].weight.copy_(torch.tensor([[0.75, 1.0]]))
    twin = (torch.nn.Linear(2, 1, bias=False),)
    twin[0].load_state_dict(theta[0].state_dict())
    committed, fetches = runner.accept_block(theta, block, None)
    assert committed[0] is theta[0] and fetches.shape == (2, 2 * 3 + 3)
    for i, shifts in enumerate(block):
        twin, fetch = runner.accept(twin, shifts, None)
        assert torch.equal(fetch, fetches[i])
    assert torch.equal(theta[0].weight, twin[0].weight)
    assert torch.equal(theta[0].weight, torch.tensor([[-0.5, -0.25]]))
    sharded = trunner.RoundRunner(
        trunner.RoundSpec(train, validate, lead=lambda s: (s.shape[0],),
                          take=lambda s, lanes, clusters: s[clusters]),
        verify=trunner.VerifyConfig(enabled=False), placement="sharded")
    with group_of_one("gloo"):
        with torch.no_grad():
            twin[0].weight.copy_(torch.tensor([[0.75, 1.0]]))
        committed, got = sharded.accept_block(twin, block, None)
    assert committed[0] is twin[0] and torch.equal(got, fetches)
    assert torch.equal(twin[0].weight, theta[0].weight)

    # sweep and pool_accept_block run, on the replica form: L thetas in L *
    # R slots, each replica selecting among its own R rows
    def train_replicas(params, shifts):
        thetas = tsplit.replicas(params)
        r = shifts.shape[-1]
        w = torch.cat([th[0].weight.detach()[None].expand(r, -1, -1) for th in thetas])
        flat = shifts.reshape(-1)
        return (Stacked(w + flat[:, None, None]),), flat

    def linear(*w):
        lin = torch.nn.Linear(2, 1, bias=False)
        with torch.no_grad():
            lin.weight.copy_(torch.tensor([w]))
        return (lin,)

    runner = trunner.RoundRunner(trunner.RoundSpec(train_replicas, validate),
                                 verify=trunner.VerifyConfig(enabled=False))
    shifts = torch.tensor([[0.5, -1.0, 2.0], [1.0, -0.25, 3.0]])
    thetas, aux, vlosses, sels = runner.sweep([linear(0.75, 1.0), linear(-0.5, 0.25)],
                                              shifts, None)
    assert sels.tolist() == [1, 1] and vlosses.shape == aux.shape == (2, 3)
    assert torch.equal(vlosses[1], torch.tensor([1.8125, 0.5625, 16.8125]))
    assert [th[0].weight.tolist() for th in thetas] == [[[-0.25, 0.0]], [[-0.75, 0.0]]]
    thetas, (vl_k, tl_k, sels_k) = runner.sweep_block(
        [linear(0.75, 1.0), linear(-0.5, 0.25)], [shifts, shifts], None)
    assert vl_k.shape == tl_k.shape == (2, 2, 3) and sels_k.tolist() == [[1, 1], [0, 0]]
    assert torch.equal(vl_k[0], vlosses)
    assert [th[0].weight.tolist() for th in thetas] == [[[0.25, 0.5]], [[0.25, 1.0]]]
    lanes = [linear(0.75, 1.0), linear(-0.5, 0.25)]
    lanes, fetches = runner.pool_accept_block(lanes, [shifts, shifts],
                                              (torch.zeros(2, 1), torch.zeros(2, 1)),
                                              torch.tensor([True, False]))
    assert fetches.shape == (2, 2, 2 * 3 + 3)
    assert fetches[:, :, 6].tolist() == [[1.0, 0.0], [1.0, 1.0]]     # selected
    assert fetches[:, :, 8].tolist() == [[1.0, 1.0], [1.0, 1.0]]     # accepted
    assert torch.equal(fetches[:, 0, :3], vlosses)
    assert lanes[0][0].weight.tolist() == [[0.25, 0.5]]      # two commits
    assert lanes[1][0].weight.tolist() == [[-0.5, 0.25]]     # idle: none
