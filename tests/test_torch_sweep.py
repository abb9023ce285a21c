"""The multi-seed sweep in the port (``run_pigeon_sweep``, ``RoundRunner.sweep``
and ``sweep_block``, ``evaluate_sweep``), on the CPU.

Held two ways, on the tiny fixtures (``conftest.tiny_task`` / ``tiny_pcfg``),
with the module's init handing each seed the reference's initial parameters
(keyed by the init generator's seed):
  * against the port itself: every replica's History is bit-equal, in every
    key it records, to the port's solo ``run_pigeon(engine="batched")`` of
    that seed (argmin and ``loss_plus_distance`` over int8, block 1 and 2, a
    heterogeneous scheduled threat model with a stochastic family);
  * against the reference: on deterministic families the discrete outcomes
    equal ``repro.core.run_pigeon_sweep``'s, the losses and test accuracy
    within rtol 1e-4.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.convert import from_reference
from repro_torch.core import engine as tengine
from repro_torch.core import runner as trunner
from repro_torch.data import build_image_task
from repro_torch.telemetry import MemorySink, Telemetry
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
SEEDS = (0, 1)
DISCRETE = ("round", "clusters", "selected", "selected_honest", "honest_cluster_exists",
            "comm")
#: the keys of a sweep record (the reference's): no accepted, no detections
SWEEP_KEYS = {"round", "clusters", "val_losses", "train_losses", "selected",
              "selected_honest", "honest_cluster_exists", "comm"}


def _pcfg(pcfg, **kw):
    """Four rounds, evaluated at rounds 0, 2 and 3, so a block of 2 spans
    two rounds."""
    return dataclasses.replace(pcfg, T=4, eval_every=2, **kw)


@pytest.fixture(scope="module")
def port(tiny_task, tiny_pcfg):
    """The port's task, its module drawing each seed's reference
    parameters, and its ProtocolConfig."""
    _, jmod = tiny_task
    data, cfg = build_image_task("mnist", **TASK)
    thetas = {}
    for s in SEEDS:
        _, k0 = jax.random.split(jax.random.PRNGKey(s))
        jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
        thetas[s] = from_reference(cfg, jg, jp)
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: thetas[g.initial_seed()])
    fields = {f.name: getattr(tiny_pcfg, f.name)
              for f in dataclasses.fields(tcore.ProtocolConfig) if f.name != "telemetry"}
    fields["comm"] = tcore.CommConfig(tiny_pcfg.comm.quant)
    return data, module, tcore.ProtocolConfig(**fields)


def _solo(module, data, pcfg, seed, **kw):
    return tcore.run_pigeon(module, data, dataclasses.replace(pcfg, seed=seed),
                            engine="batched", device="cpu", **kw)


def assert_replica_is_solo(h_sweep, h_solo):
    """Every key the sweep records equals the solo run's, floats bit for bit."""
    assert len(h_sweep.rounds) == len(h_solo.rounds)
    for rw, rs in zip(h_sweep.rounds, h_solo.rounds):
        assert set(rw) - {"test_acc"} == SWEEP_KEYS
        assert ("test_acc" in rw) == ("test_acc" in rs)
        assert rs["accepted"] and rs["detections"] == 0
        for k in rw:
            assert rw[k] == rs[k], (rw["round"], k, rw[k], rs[k])


def _hetero(core):
    """Label flip every other round on client 0, a scaled gradient on 1 and,
    when ``noise``, Gaussian gradient noise on 3."""
    def build(noise: bool):
        threats = {0: core.ClientThreat(core.Attack(core.LABEL_FLIP), core.every_k(2)),
                   1: core.Attack(core.GRAD_SCALE, grad_scale=4.0)}
        if noise:
            threats[3] = core.Attack(core.GRAD_NOISE, noise_std=0.5)
        return core.ThreatModel.build(threats)
    return build


LF = dict(malicious={1}, attack=tcore.Attack(tcore.LABEL_FLIP))


@pytest.mark.parametrize("case", [
    dict(block=1),
    dict(block=2),
    dict(block=2, selection="loss_plus_distance", quant="int8"),
    dict(block=1, threat_model=_hetero(tcore)(noise=True)),
], ids=["block1", "block2", "block2-lpd-int8", "block1-hetero-noise"])
def test_sweep_replicas_equal_solo_runs(port, case):
    data, module, pcfg = port
    pcfg = _pcfg(pcfg)
    case = dict(case)
    block = case.pop("block")
    threat = case if "threat_model" in case else {**LF, **case}
    hists = tcore.run_pigeon_sweep(module, data, pcfg, seeds=SEEDS, block=block,
                                   device="cpu", **threat)
    assert len(hists) == len(SEEDS)
    for hist, seed in zip(hists, SEEDS):
        assert_replica_is_solo(hist, _solo(module, data, pcfg, seed, **threat))
    if "threat_model" in case:
        # the noisy family's client trains in some cluster every round
        assert any(3 in c for r in hists[0].rounds for c in r["clusters"])


@pytest.fixture(scope="module")
def reference_sweep(tiny_task, tiny_pcfg):
    data, module = tiny_task
    return jcore.run_pigeon_sweep(module, data, _pcfg(tiny_pcfg),
                                  threat_model=_hetero(jcore)(noise=False), seeds=SEEDS,
                                  block=2)


def test_sweep_matches_reference(port, reference_sweep):
    data, module, pcfg = port
    hists = tcore.run_pigeon_sweep(module, data, _pcfg(pcfg),
                                   threat_model=_hetero(tcore)(noise=False), seeds=SEEDS,
                                   block=2, device="cpu")
    for ht, hj in zip(hists, reference_sweep):
        assert len(ht.rounds) == len(hj.rounds)
        for rt, rj in zip(ht.rounds, hj.rounds):
            assert rt.keys() == rj.keys()
            for k in DISCRETE:
                assert rt[k] == rj[k], (rt["round"], k, rt[k], rj[k])
            for k in ("val_losses", "train_losses", "test_acc"):
                if k in rj:
                    np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, atol=0)


def test_sweep_block_fetches_once_a_block(port):
    """Block 2 over T = 4 (eval at 0, 2, 3): blocks (0,), (1, 2), (3,), one
    ``block.fetch`` span each; each round's event carries its seed; the
    History equals block 1's."""
    data, module, pcfg = port
    pcfg = _pcfg(pcfg)
    sink = MemorySink()
    h2 = tcore.run_pigeon_sweep(module, data, pcfg, seeds=SEEDS, block=2, device="cpu",
                                telemetry=Telemetry(sinks=(sink,)), **LF)
    spans = [e["name"] for e in sink.of("span")]
    assert spans.count("block.fetch") == spans.count("block.step") == 3
    assert spans.count("round.eval") == 3
    rounds = sink.of("round")
    assert [(e["t"], e["seed"]) for e in rounds] == [(t, s) for t in range(4) for s in SEEDS]
    h1 = tcore.run_pigeon_sweep(module, data, pcfg, seeds=SEEDS, device="cpu", **LF)
    for a, b in zip(h1, h2):
        assert a.rounds == b.rounds


def test_sweep_runner_entries(port):
    """``RoundRunner.sweep`` on the replica payload: per seed the winner of
    its own R scores, carried into its theta in place; ``sweep_block`` over
    K rounds stacks (K, S, R) losses and (K, S) selections, equal to K
    ``sweep`` calls; ``sweep_round`` and ``evaluate_sweep`` agree with
    them and with ``evaluate``."""
    data, module, pcfg = port
    tm = tcore.ThreatModel.from_legacy(LF["malicious"], LF["attack"])
    rngs = [np.random.default_rng(s) for s in SEEDS]
    gens = [torch.Generator().manual_seed(100 + s) for s in SEEDS]
    _, rounds = tengine.assemble_sweep_block(rngs, gens, data, pcfg, tm, 0, 2, "cpu")
    val = (torch.from_numpy(data.x0), torch.from_numpy(data.y0))

    def thetas():
        return [tuple(m for m in module.init(torch.Generator().manual_seed(s)))
                for s in SEEDS]

    import copy
    runner = trunner.protocol_runner(module, pcfg.lr)
    a = copy.deepcopy(thetas())
    b = copy.deepcopy(thetas())
    steps = []
    for inputs in rounds:
        a, aux, vl, sel = runner.sweep(a, inputs, val)
        assert vl.shape == (len(SEEDS), pcfg.R) and sel.shape == (len(SEEDS),)
        assert aux.shape == (len(SEEDS), pcfg.R, pcfg.M // pcfg.R)
        assert torch.equal(sel, torch.argmin(vl, dim=1))
        steps.append((vl, aux.mean(dim=-1), sel))
    b, (vl_k, tl_k, sel_k) = runner.sweep_block(b, rounds, val)
    assert vl_k.shape == (2, len(SEEDS), pcfg.R) and sel_k.shape == (2, len(SEEDS))
    for i, (vl, tl, sel) in enumerate(steps):
        assert torch.equal(vl_k[i], vl) and torch.equal(tl_k[i], tl)
        assert torch.equal(sel_k[i], sel)
    for ta, tb in zip(a, b):
        for ma, mb in zip(ta, tb):
            for pa, pb in zip(ma.parameters(), mb.parameters()):
                assert torch.equal(pa, pb)
    c = copy.deepcopy(thetas())
    c, _, vl_c, sel_c = tengine.sweep_round(module, pcfg.lr, c, rounds[0], val)
    assert torch.equal(vl_c, steps[0][0]) and torch.equal(sel_c, steps[0][2])
    accs = tengine.evaluate_sweep(module, [t[0] for t in b], [t[1] for t in b],
                                  data.x_test, data.y_test, batch=64)
    assert accs.shape == (len(SEEDS),)
    for acc, (g, p) in zip(accs, b):
        assert acc == tcore.evaluate(module, g, p, data.x_test, data.y_test, 64)


def test_sweep_refusals(port):
    data, module, pcfg = port
    with pytest.raises(ValueError, match="param-tamper"):
        tcore.run_pigeon_sweep(module, data, pcfg, malicious={1},
                               attack=tcore.Attack(tcore.PARAM_TAMPER), device="cpu")
    # the sharded placement runs in a process group: a group of one is the
    # vmap run (tests/test_torch_sharded.py holds 2 to 4 ranks)
    from repro_torch.launch.mesh import group_of_one
    want = [h.rounds for h in tcore.run_pigeon_sweep(module, data, pcfg, seeds=SEEDS,
                                                     device="cpu")]
    with group_of_one("gloo"):
        got = tcore.run_pigeon_sweep(module, data, pcfg, seeds=SEEDS, placement="sharded",
                                     device="cpu")
    assert [h.rounds for h in got] == want
