"""Parity of the port's batched Pigeon-SL round with the JAX reference's
batched engine, and of the port's two engines with each other, on the tiny
fixtures (``conftest.tiny_task`` / ``tiny_pcfg``) from the converted JAX
init.

The discrete outcomes (clusters, selections, acceptances, detections,
honesty flags and the bit-identical ``comm`` dicts) must be equal.  Floats
agree at rtol 1e-4 on f32 runs and 1e-3 on quantized runs, where a tiny
float drift can move one element across a rounding boundary of the
quantizer; the port's two engines differ only in summation order (grouped
convolutions, batched products), so they share those tolerances."""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.adversary as jadv
import repro.core as jcore
import repro_torch.adversary as tadv
import repro_torch.core as tcore
from repro_torch.convert import from_reference
from repro_torch.core import engine as tengine
from repro_torch.core import runner as trunner
from repro_torch.data import build_image_task as torch_build_image_task
from repro_torch.kernels import ops as tops
from repro_torch.selection import resolve_policy, unpack_fetch
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")
FLOATS = ("val_losses", "train_losses", "test_acc")


def _threat_model(adv):
    """One heterogeneous threat model, built alike in both packages: a
    label flipper, an intermittent gradient scaler and a sleeper backdoor."""
    return adv.ThreatModel.build({
        0: adv.Attack(adv.LABEL_FLIP),
        2: adv.ClientThreat(adv.Attack(adv.GRAD_SCALE, grad_scale=4.0),
                            adv.every_k(2)),
        3: adv.ClientThreat(adv.Attack(adv.BACKDOOR), adv.after_warmup(1)),
    })


# name -> (run_pigeon kwargs; the attack and threat model are built per
# package from the "attack" kind and the "threat_model" flag)
CASES = {
    "honest": dict(),
    "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
    "gradient": dict(malicious={1}, attack=jcore.GRADIENT),
    "int8_loss_plus_distance": dict(quant="int8", selection="loss_plus_distance"),
    "fp8_argmin": dict(quant="fp8_e4m3"),
    "param_tamper_last": dict(malicious={2, 3}, attack=jcore.PARAM_TAMPER),
    "plus": dict(plus=True),
    "median_of_means": dict(malicious={1}, attack=jcore.LABEL_FLIP,
                            selection="median_of_means"),
    "heterogeneous": dict(threat_model=True),
}
# the port's engines against each other: the reference's cases plus the
# stochastic families, which the shared noise discipline makes comparable,
# and the host cascade of the batched engine reading shard losses and
# message statistics out of its stacked candidates
ENGINE_CASES = dict(CASES,
                    activation=dict(malicious={1}, attack=jcore.ACTIVATION),
                    grad_noise=dict(malicious={0}, attack=jcore.GRAD_NOISE),
                    replay_trimmed=dict(malicious={1}, attack=jcore.REPLAY,
                                        selection="trimmed"),
                    param_tamper_median_of_means=dict(
                        malicious={2, 3}, attack=jcore.PARAM_TAMPER,
                        selection="median_of_means"),
                    param_tamper_int8_loss_plus_distance=dict(
                        malicious={2, 3}, attack=jcore.PARAM_TAMPER, quant="int8",
                        selection="loss_plus_distance"))


def _kwargs(case, pkg, adv):
    kw = dict(ENGINE_CASES[case])
    if kw.pop("threat_model", False):
        kw["threat_model"] = _threat_model(adv)
    else:
        kw["attack"] = pkg.Attack(kw.pop("attack", pkg.NONE))
    return kw


@pytest.fixture(scope="module")
def port(tiny_task, tiny_pcfg):
    """The port's task, its module carrying the reference's initial
    parameters for ``tiny_pcfg.seed``, and its ProtocolConfig."""
    jdata, jmod = tiny_task
    data, cfg = torch_build_image_task("mnist", **TASK)
    _, k0 = jax.random.split(jax.random.PRNGKey(tiny_pcfg.seed))   # run_pigeon's init key
    jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
    theta = from_reference(cfg, jg, jp)
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: theta)
    fields = {f.name: getattr(tiny_pcfg, f.name)
              for f in dataclasses.fields(tcore.ProtocolConfig)}
    fields["comm"] = tcore.CommConfig(tiny_pcfg.comm.quant)
    return data, module, tcore.ProtocolConfig(**fields)


@pytest.fixture(scope="module")
def histories(tiny_task, tiny_pcfg, port):
    """Memoised runs: (package, engine, case) -> History."""
    cache = {}

    def get(pkg, engine, case):
        if (pkg, engine, case) not in cache:
            if pkg == "jax":
                jdata, jmod = tiny_task
                cache[pkg, engine, case] = jcore.run_pigeon(
                    jmod, jdata, tiny_pcfg, engine=engine,
                    **_kwargs(case, jcore, jadv))
            else:
                data, module, pcfg = port
                cache[pkg, engine, case] = tcore.run_pigeon(
                    module, data, pcfg, engine=engine, device="cpu",
                    **_kwargs(case, tcore, tadv))
        return cache[pkg, engine, case]

    return get


def _assert_same_rounds(ha, hb, case, rtol):
    assert len(ha.rounds) == len(hb.rounds)
    for ra, rb in zip(ha.rounds, hb.rounds):
        for k in DISCRETE:
            assert ra[k] == rb[k], (case, ra["round"], k)
        for k in FLOATS:
            np.testing.assert_allclose(ra[k], rb[k], rtol=rtol, atol=0,
                                       err_msg=f"{case} round {ra['round']} {k}")


def _rtol(case):
    return 1e-3 if ENGINE_CASES[case].get("quant") else 1e-4


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_round_matches_reference_batched_engine(case, tiny_pcfg, histories):
    hj = histories("jax", "batched", case)
    ht = histories("torch", "batched", case)
    assert len(ht.rounds) == tiny_pcfg.T
    _assert_same_rounds(ht, hj, case, _rtol(case))
    if case == "param_tamper_last":
        assert sum(r["detections"] for r in ht.rounds) > 0


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_batched_and_sequential_engines_agree(case, histories):
    _assert_same_rounds(histories("torch", "batched", case),
                        histories("torch", "sequential", case), case, _rtol(case))


def test_fused_path_runs_the_tamper_check_once_per_round(port, monkeypatch):
    """Without param tamperers the batched round never enters the host
    cascade; its verify stage takes all R candidates in one tamper_verdict
    call, which sees identical inputs and returns exactly 0."""
    data, module, pcfg = port
    seen = []
    real = tops.tamper_verdict

    def spy(ref, recv, tol):
        passed, dists = real(ref, recv, tol)
        seen.append((tuple(ref.shape[:2]), ref is recv, tol, passed.tolist(),
                     dists.tolist()))
        return passed, dists

    def refuse(*_a, **_k):
        raise AssertionError("the fused path entered the host cascade")

    monkeypatch.setattr(tops, "tamper_verdict", spy)
    monkeypatch.setattr(tcore.protocol, "select_host", refuse)
    tcore.run_pigeon(module, data, pcfg, malicious={1},
                     attack=tcore.Attack(tcore.LABEL_FLIP), engine="batched",
                     device="cpu")
    assert seen == [((pcfg.R, TASK["d_o"]), True, pcfg.tamper_tol, [True] * pcfg.R,
                     [0.0] * pcfg.R)] * pcfg.T


def test_fused_cascade_rejects_a_diverged_candidate(port):
    """A candidate whose validation activations are not finite fails the
    check (NaN distance), as in the reference: the accept step commits the
    next candidate and counts the detection."""
    data, module, pcfg = port
    rng = np.random.default_rng(pcfg.seed)
    clusters = tcore.make_clusters(rng, pcfg.M, pcfg.R)
    payload = tengine.assemble_round(rng, torch.Generator().manual_seed(0), data,
                                     clusters, pcfg, tadv.ThreatModel(), 0,
                                     torch.device("cpu"))
    runner = trunner.protocol_accept_runner(module, pcfg.lr,
                                            resolve_policy("argmin"), True,
                                            pcfg.tamper_tol)
    validate = runner.spec.validate

    def poisoned(stacked, val):
        vloss, acts = validate(stacked, val)
        acts, vloss = acts.clone(), vloss.clone()
        acts[0, 0, 0] = float("nan")
        vloss[0] = -1.0                         # the best score: visited first
        return vloss, acts

    runner.spec = dataclasses.replace(runner.spec, validate=poisoned)
    theta = tuple(copy.deepcopy(m) for m in module.init(None))
    before = [p.clone() for p in theta[0].parameters()]
    val = (torch.from_numpy(data.x0), torch.from_numpy(data.y0))
    committed, fetch = runner.accept(theta, payload, val)
    _, _, selected, detections, accepted = unpack_fetch(fetch.numpy(), pcfg.R)
    assert (selected, detections, accepted) == (1, 1, True)
    assert committed[0] is theta[0]             # committed in place
    assert not all(torch.equal(a, b) for a, b in zip(before, theta[0].parameters()))


# ---------------------------------------------------------------------------
# the verify stage's recompute (VerifyConfig.recompute, RoundSpec.handoff_acts)
# ---------------------------------------------------------------------------

def _recompute_round(pkg, port, tiny_task, tiny_pcfg, shift, monkeypatch=None):
    """One fused round whose verify stage re-derives the handoff through
    ``handoff_acts`` (``recompute=True``, the default), the re-transmission
    shifted by ``shift``: ((selected, detections, accepted), theta moved)."""
    from repro.core import engine as jengine
    from repro.core import runner as jrunner
    from repro.selection import unpack_fetch as jax_unpack_fetch
    import jax.numpy as jnp

    rng = np.random.default_rng(tiny_pcfg.seed)
    clusters = tcore.make_clusters(rng, tiny_pcfg.M, tiny_pcfg.R)
    if pkg == "jax":
        jdata, jmod = tiny_task
        _, payload = jengine.assemble_round(rng, jax.random.PRNGKey(0), jdata, clusters,
                                            tiny_pcfg, jadv.ThreatModel(), 0)
        spec = jrunner.protocol_round_spec(jmod, tiny_pcfg.lr)
        real = spec.handoff_acts
        spec = dataclasses.replace(spec, handoff_acts=lambda th, val: real(th, val) + shift)
        runner = jrunner.RoundRunner(spec, verify=jrunner.VerifyConfig(
            tol=tiny_pcfg.tamper_tol))
        _, k0 = jax.random.split(jax.random.PRNGKey(tiny_pcfg.seed))
        theta = jmod.init(k0)
        before = [np.array(a) for a in jax.tree.leaves(theta)]   # accept donates theta
        committed, fetch = runner.accept(theta, payload, (jnp.asarray(jdata.x0),
                                                          jnp.asarray(jdata.y0)))
        moved = not all(np.array_equal(a, b) for a, b in zip(
            jax.tree.leaves(committed), before))
        return jax_unpack_fetch(np.asarray(fetch), tiny_pcfg.R)[2:], moved
    data, module, pcfg = port
    payload = tengine.assemble_round(rng, torch.Generator().manual_seed(0), data,
                                     clusters, pcfg, tadv.ThreatModel(), 0,
                                     torch.device("cpu"))
    spec = trunner.protocol_round_spec(module, pcfg.lr)
    real = spec.handoff_acts
    spec = dataclasses.replace(spec, handoff_acts=lambda th, val: real(th, val) + shift)
    runner = trunner.RoundRunner(spec, verify=trunner.VerifyConfig(tol=pcfg.tamper_tol))
    theta = tuple(copy.deepcopy(m) for m in module.init(None))
    before = [p.clone() for m in theta for p in m.parameters()]
    _, fetch = runner.accept(theta, payload, (torch.from_numpy(data.x0),
                                              torch.from_numpy(data.y0)))
    moved = not all(torch.equal(a, b) for a, b in zip(
        before, [p for m in theta for p in m.parameters()]))
    return unpack_fetch(fetch.numpy(), pcfg.R)[2:], moved


@pytest.mark.parametrize("shift", [0.0, 0.5], ids=["faithful", "diverged"])
def test_recompute_verify_matches_reference(port, tiny_task, tiny_pcfg, shift,
                                            monkeypatch):
    """With ``recompute`` the verify stage holds the re-derived handoff
    against the validation activations (B1's distinct route): a faithful
    re-transmission passes every candidate; one shifted beyond ``tol`` is
    rejected for every candidate and theta is kept — on both packages, with
    the same selected, detections and accepted."""
    routes = []
    real = tops.tamper_verdict

    def spy(ref, recv, tol):
        routes.append(ref is recv)
        return real(ref, recv, tol)

    monkeypatch.setattr(tops, "tamper_verdict", spy)
    got = _recompute_round("torch", port, tiny_task, tiny_pcfg, shift)
    want = _recompute_round("jax", port, tiny_task, tiny_pcfg, shift)
    assert got == want
    assert routes == [False]                   # one call, distinct inputs
    (_, detections, accepted), moved = got
    if shift:
        assert (detections, accepted, moved) == (tiny_pcfg.R, False, False)
    else:
        assert (detections, accepted, moved) == (0, True, True)


def test_recompute_without_the_hook_raises_on_both_packages(port, tiny_task, tiny_pcfg):
    """``recompute=True`` (the default) with no ``handoff_acts`` raises
    ``ValueError`` when the round runs, not when the runner is built."""
    from repro.core import runner as jrunner
    import jax.numpy as jnp

    jdata, jmod = tiny_task
    jspec = dataclasses.replace(jrunner.protocol_round_spec(jmod, tiny_pcfg.lr),
                                handoff_acts=None)
    jr = jrunner.RoundRunner(jspec)
    with pytest.raises(ValueError, match="handoff_acts"):
        jr.accept(jmod.init(jax.random.PRNGKey(0)), None,
                  (jnp.asarray(jdata.x0), jnp.asarray(jdata.y0)))
    data, module, pcfg = port
    tspec = dataclasses.replace(trunner.protocol_round_spec(module, pcfg.lr),
                                handoff_acts=None)
    tr = trunner.RoundRunner(tspec)
    for entry in (tr.accept, tr.accept_block):
        with pytest.raises(ValueError, match="handoff_acts"):
            entry(None, None, None)
    off = trunner.RoundRunner(tspec, verify=trunner.VerifyConfig(recompute=False))
    assert off.verify.recompute is False and trunner.VerifyConfig().recompute is True
    assert trunner.protocol_accept_runner(module, pcfg.lr, resolve_policy("argmin"), True,
                                          pcfg.tamper_tol).verify.recompute is False
