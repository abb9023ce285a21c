"""Parity of the port's split CNNs and cut-layer exchange with the JAX
reference: converted reference parameters, the same seeded numpy inputs.

Floats agree at rtol 1e-5 / atol 1e-6: XLA and PyTorch sum convolutions and
matrix products in different orders."""
import copy
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import attacks as jatk
from repro.core import from_cnn as jax_from_cnn
from repro.core.split import client_update_stats as jax_client_update_stats
from repro.core.split import sl_minibatch_grads
from repro.models import cnn as jcnn
from repro_torch.adversary import specs as tspecs
from repro_torch.convert import from_reference, to_reference
from repro_torch.core.split import client_update_stats as torch_client_update_stats
from repro_torch.core.split import from_cnn as torch_from_cnn
from repro_torch.core.split import sl_minibatch_grads as torch_grads
from repro_torch.models import cnn as tcnn
from _torch_threads import one_thread  # noqa: F401

# the packages export a ``families()`` function that shadows the submodule
jfam = importlib.import_module("repro.adversary.families")
tfam = importlib.import_module("repro_torch.adversary.families")

RTOL, ATOL = 1e-5, 1e-6
# one compiled program per case instead of op-by-op dispatch (fast tier)
jax_grads = jax.jit(sl_minibatch_grads, static_argnums=(0, 1),
                    static_argnames=("with_stats", "quant"))
CONFIGS = {"mnist": (jcnn.MNIST_CNN, tcnn.MNIST_CNN),
           "cifar": (jcnn.CIFAR_CNN, tcnn.CIFAR_CNN)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    """(name, jax module, jax params, torch module, torch params, x, y) at
    B = 4 with the reference's own init."""
    jcfg, tcfg = CONFIGS[request.param]
    jmod = jax_from_cnn(jcfg)
    jg, jp = jax.jit(jmod.init)(jax.random.PRNGKey(3))
    tg, tp = from_reference(tcfg, _np_tree(jg), _np_tree(jp))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, jcfg.image_size, jcfg.image_size,
                         jcfg.in_channels)).astype(np.float32)
    y = rng.integers(0, 10, size=4).astype(np.int32)
    return request.param, jmod, (jg, jp), torch_from_cnn(tcfg), (tg, tp), x, y


def _assert_tree_close(actual, desired, rtol=RTOL, atol=ATOL):
    la, ld = jax.tree.leaves(actual), jax.tree.leaves(desired)
    assert len(la) == len(ld)
    for a, d in zip(la, ld):
        np.testing.assert_allclose(np.asarray(a), np.asarray(d), rtol=rtol, atol=atol)


def _grads_as_reference(gamma, phi, g_gamma, g_phi):
    """The port's gradient lists (``parameters()`` order) in the reference's
    pytree layout."""
    gm, pm = copy.deepcopy(gamma), copy.deepcopy(phi)
    for mod, grads in ((gm, g_gamma), (pm, g_phi)):
        for p, g in zip(mod.parameters(), grads):
            p.data = g.detach().clone()
    return to_reference(gm, pm)


def test_convert_round_trip_is_exact(pair):
    _, _, (jg, jp), _, _, _, _ = pair
    g, p = to_reference(*from_reference(CONFIGS[pair[0]][1], _np_tree(jg), _np_tree(jp)))
    for a, d in zip(jax.tree.leaves((g, p)), jax.tree.leaves((jg, jp))):
        assert a.shape == d.shape and a.dtype == d.dtype
        np.testing.assert_array_equal(a, d)


def test_torch_init_matches_reference_shapes_and_scale(pair):
    """The port draws its own init (a torch generator), in the reference's
    shapes and layout, with the same fan-in scaling."""
    _, _, (jg, jp), _, _, _, _ = pair
    g, p = to_reference(*tcnn.cnn_init(torch.Generator().manual_seed(0),
                                       CONFIGS[pair[0]][1]))
    for a, d in zip(jax.tree.leaves((g, p)), jax.tree.leaves((jg, jp))):
        assert a.shape == d.shape
        np.testing.assert_allclose(np.std(a), np.std(np.asarray(d)), rtol=0.25, atol=1e-7)


def test_client_forward_and_ap_loss(pair):
    _, jmod, (jg, jp), tmod, (tg, tp), x, y = pair
    j_acts = jmod.client_forward(jg, x)
    with torch.no_grad():
        t_acts = tmod.client_forward(tg, torch.from_numpy(x))
        t_loss = tmod.ap_loss(tp, t_acts, torch.from_numpy(y))
    np.testing.assert_allclose(t_acts.numpy(), np.asarray(j_acts), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(t_loss), float(jmod.ap_loss(jp, j_acts, y)),
                               rtol=RTOL, atol=ATOL)


EXCHANGES = {
    "honest": (jatk.HONEST, None, False),
    "label_flip": (jatk.Attack(jatk.LABEL_FLIP), None, False),
    "gradient": (jatk.Attack(jatk.GRADIENT), None, False),
    "int8": (jatk.HONEST, "int8", False),
    "int8_stats": (jatk.HONEST, "int8", True),
    "fp8_e4m3": (jatk.HONEST, "fp8_e4m3", False),
    "f32_stats": (jatk.Attack(jatk.LABEL_FLIP), None, True),
    "replay_int8_stats": (jatk.Attack(jatk.REPLAY), "int8", True),
    "backdoor": (jatk.Attack(jatk.BACKDOOR), None, False),
}


@pytest.mark.parametrize("case", sorted(EXCHANGES))
def test_sl_exchange(pair, case):
    """One four-message exchange: (g_gamma, g_phi, loss) and, with stats,
    the transmitted message's stats."""
    _, jmod, (jg, jp), tmod, (tg, tp), x, y = pair
    attack, quant, with_stats = EXCHANGES[case]
    jout = jax_grads(jmod, attack, jg, jp, x, y, jax.random.PRNGKey(1),
                     with_stats=with_stats, quant=quant)
    tout = torch_grads(tmod, tspecs.Attack(attack.kind), tg, tp,
                       torch.from_numpy(x), torch.from_numpy(y), None,
                       with_stats=with_stats, quant=quant)
    assert len(jout) == len(tout)
    _assert_tree_close(_grads_as_reference(tg, tp, tout[0], tout[1]),
                       (jout[0], jout[1]))
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=RTOL, atol=ATOL)
    if with_stats:
        np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                                   rtol=RTOL, atol=ATOL)


def test_activation_blend_with_reference_noise(pair):
    """The activation attack: the reference's own normal draw, handed to the
    port, gives the same blend and the same exchange."""
    _, jmod, (jg, jp), tmod, (tg, tp), x, y = pair
    key = jax.random.PRNGKey(5)
    k_act, _ = jax.random.split(key)              # the exchange's act-side key
    acts = jmod.client_forward(jg, x)
    noise = np.array(jax.random.normal(k_act, acts.shape, np.float32))
    blend_j = jfam._noise_blend(acts, k_act, 0.1)
    blend_t = tfam._noise_blend(torch.from_numpy(np.array(acts)),
                                torch.from_numpy(noise), 0.1)
    np.testing.assert_allclose(blend_t.numpy(), np.asarray(blend_j), rtol=RTOL, atol=ATOL)

    attack = jatk.Attack(jatk.ACTIVATION)
    jout = jax_grads(jmod, attack, jg, jp, x, y, key)
    tout = torch_grads(tmod, tspecs.Attack(attack.kind), tg, tp, torch.from_numpy(x),
                       torch.from_numpy(y), torch.from_numpy(noise))
    _assert_tree_close(_grads_as_reference(tg, tp, tout[0], tout[1]),
                       (jout[0], jout[1]))
    np.testing.assert_allclose(float(tout[2]), float(jout[2]), rtol=RTOL, atol=ATOL)


def test_grad_noise_and_param_tamper_with_reference_noise():
    """The other two noise-taking helpers, fed the reference's draws."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(4, 32)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, g.shape, np.float32))
    np.testing.assert_allclose(
        tfam._grad_noise(torch.from_numpy(g), torch.from_numpy(noise), 0.5).numpy(),
        np.asarray(jfam._grad_noise(g, key, 0.5)), rtol=RTOL, atol=ATOL)

    jcfg, tcfg = jcnn.MNIST_CNN, tcnn.MNIST_CNN
    jg, jp = jax.jit(jcnn.cnn_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tg, _ = from_reference(tcfg, _np_tree(jg), _np_tree(jp))
    spec = jatk.Attack(jatk.PARAM_TAMPER)

    @jax.jit
    def reference(params, k):
        """The tampered params and the per-leaf draws behind them."""
        leaves, treedef = jax.tree.flatten(params)
        draws = [jax.random.normal(kk, leaf.shape, leaf.dtype)
                 for leaf, kk in zip(leaves, jax.random.split(k, len(leaves)))]
        return jfam._tamper_params(spec, params, k), jax.tree.unflatten(treedef, draws)

    tampered_j, draws = _np_tree(reference(jg, key))
    # the reference's draws, laid out as the port's parameters
    noise_mod, _ = from_reference(tcfg, draws, _np_tree(jp))
    tampered_t = tfam._tamper_params(tspecs.Attack(spec.kind), tg,
                                     [p.detach() for p in noise_mod.parameters()])
    _assert_tree_close(to_reference(tampered_t, tcnn.APHead(tcfg))[0], tampered_j)
    # the handed-in module is left as it was
    _assert_tree_close(to_reference(tg, tcnn.APHead(tcfg))[0], jg, rtol=0, atol=0)


def test_client_update_two_steps(pair):
    """A client turn of E = 2 SGD steps (in-place updates on the port's
    side) with the int8 wire and message stats: the updated parameters, the
    mean loss and the mean stats."""
    _, jmod, (jg, jp), tmod, (tg, tp), x, y = pair
    xs = np.stack([x, x[::-1].copy()])
    ys = np.stack([y, y[::-1].copy()])
    jg2, jp2, jloss, jst = jax_client_update_stats(
        jmod, jatk.HONEST, jg, jp, (xs, ys), 0.05, jax.random.PRNGKey(0), quant="int8")
    tg2, tp2 = copy.deepcopy(tg), copy.deepcopy(tp)
    _, _, tloss, tst = torch_client_update_stats(
        tmod, tspecs.HONEST, tg2, tp2, (torch.from_numpy(xs), torch.from_numpy(ys)),
        0.05, None, quant="int8")
    _assert_tree_close(to_reference(tg2, tp2), (jg2, jp2))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=RTOL, atol=ATOL)
