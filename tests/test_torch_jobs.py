"""The job pool in the port (``core/jobs.py``, ``RoundRunner.pool_accept_block``,
``checkpoint.job_checkpoint_metadata``), on the CPU.

Held two ways, on the tiny fixtures (``conftest.tiny_task``), with the
module's init handing each job's seed the reference's initial parameters:
  * against the port itself: every pooled job's History is bit-equal to its
    solo ``run_pigeon(engine="batched")`` (block 1 and 2, fewer lanes than
    jobs, mixed threat models and horizons, the feeder, several buckets,
    checkpoints written in the pool and resumed solo and the other way
    round), and its telemetry round events mirror the solo run's;
  * against the reference: ``repro.core.jobs.run_job_pool``'s discrete
    outcomes, its losses within rtol 1e-4, and ``plan_pool``'s schedule.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.jobs as jjobs
import repro_torch.core as tcore
from repro_torch.checkpoint import job_checkpoint_metadata, load_checkpoint
from repro_torch.convert import from_reference
from repro_torch.core import jobs as tjobs
from repro_torch.core import runner as trunner
from repro_torch.data import build_image_task
from repro_torch.telemetry import MemorySink, Telemetry
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
SEEDS = (0, 1, 2, 3)
DISCRETE = ("round", "clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")


def _pcfg(core, seed, t=4, eval_every=None, **kw):
    return core.ProtocolConfig(M=4, N=1, T=t, E=2, B=16, lr=0.05, seed=seed,
                               eval_every=t if eval_every is None else eval_every, **kw)


@pytest.fixture(scope="module")
def port(tiny_task):
    """The port's task and its module drawing each seed's reference
    parameters."""
    _, jmod = tiny_task
    data, cfg = build_image_task("mnist", **TASK)
    thetas = {}
    for s in SEEDS:
        _, k0 = jax.random.split(jax.random.PRNGKey(s))
        jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
        thetas[s] = from_reference(cfg, jg, jp)
    return data, dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: thetas[g.initial_seed()])


def _specs(port, n=3, t=4, **kw):
    data, module = port
    return [tjobs.JobSpec(name=f"job{s}", module=module, data=data,
                          pcfg=_pcfg(tcore, seed=s, t=t), **kw) for s in range(n)]


def _solo(spec, block, **kw):
    return tcore.run_pigeon(spec.module, spec.data, spec.pcfg, malicious=spec.malicious,
                            attack=spec.attack, threat_model=spec.threat_model,
                            selection=spec.selection, quant=spec.quant, engine="batched",
                            block=block, device="cpu", **kw)


def assert_history_identical(h_pool, h_solo):
    assert len(h_pool.rounds) == len(h_solo.rounds)
    for a, b in zip(h_pool.rounds, h_solo.rounds):
        assert a == b, (a, b)       # every key, comm and test_acc included


def _run(specs, **kw):
    return tjobs.run_job_pool(specs, device="cpu", **kw)


# ---------------------------------------------------------------------------
# pooled == solo, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [1, 2])
def test_pool_matches_solo(port, block):
    specs = _specs(port, n=3, t=4)
    pooled = _run(specs, block=block)
    for s in specs:
        assert_history_identical(pooled[s.name], _solo(s, block))


def test_pool_mixed_threat_models(port):
    """Threat state is lane data: an honest job, a label-flipped one, a
    noisy-gradient one and one over the int8 wire with
    ``loss_plus_distance`` (a bucket of its own) stay bit-equal to their
    solo runs."""
    data, module = port
    specs = [
        tjobs.JobSpec(name="honest", module=module, data=data, pcfg=_pcfg(tcore, 0)),
        tjobs.JobSpec(name="flip", module=module, data=data, pcfg=_pcfg(tcore, 1),
                      malicious={1}, attack=tcore.Attack(tcore.LABEL_FLIP)),
        tjobs.JobSpec(name="noise", module=module, data=data, pcfg=_pcfg(tcore, 2),
                      malicious={0, 3}, attack=tcore.Attack(tcore.GRAD_NOISE, noise_std=0.5)),
        tjobs.JobSpec(name="lpd", module=module, data=data, pcfg=_pcfg(tcore, 3),
                      malicious={2}, attack=tcore.Attack(tcore.LABEL_FLIP), quant="int8",
                      selection="loss_plus_distance"),
    ]
    assert len(tjobs.JobPool(specs).buckets()) == 2
    pooled = _run(specs, block=2)
    for s in specs:
        assert_history_identical(pooled[s.name], _solo(s, 2))


@pytest.mark.parametrize("prefetch", [0, 1])
def test_pool_elastic_refill(port, prefetch):
    """Fewer lanes than jobs and ragged horizons: a finished job frees its
    lane mid-pool and the queue refills it (with the feeder too); every
    History still exact."""
    specs = [dataclasses.replace(s, pcfg=dataclasses.replace(s.pcfg, T=3 + i, eval_every=2))
             for i, s in enumerate(_specs(port, n=3))]
    sink = MemorySink()
    pooled = _run(specs, block=2, lanes=2, prefetch=prefetch,
                  telemetry=Telemetry(sinks=(sink,)))
    for s in specs:
        assert_history_identical(pooled[s.name], _solo(s, 2))
    blocks = sink.of("pool_block")
    assert [sorted(b["jobs"]) for b in blocks][-1] == ["job2"]    # job2 refilled a lane
    spans = [e["name"] for e in sink.of("span")]
    assert spans.count("pool.fetch") == spans.count("pool.step") == len(blocks)
    assert spans.count("pool.feeder_wait" if prefetch else "block.assemble") == len(blocks)


def test_pool_block1_matches_blockK(port):
    specs = _specs(port, n=2, t=4)
    h1 = _run(specs, block=1)
    hk = _run(specs, block=4)
    for s in specs:
        assert_history_identical(h1[s.name], hk[s.name])


def test_pool_multi_bucket_run(port):
    """Two incompatible shapes run as two buckets in one call."""
    data, module = port
    specs = [tjobs.JobSpec(name="fast", module=module, data=data, pcfg=_pcfg(tcore, 0)),
             tjobs.JobSpec(name="slow", module=module, data=data,
                           pcfg=dataclasses.replace(_pcfg(tcore, 1), lr=0.01))]
    assert len(tjobs.JobPool(specs).buckets()) == 2
    pooled = _run(specs, block=2)
    for s in specs:
        assert_history_identical(pooled[s.name], _solo(s, 2))


# ---------------------------------------------------------------------------
# checkpoints: pool -> pool, pool -> solo, solo -> pool
# ---------------------------------------------------------------------------

def _ckpt_specs(port, tmp_path, resume, t=4):
    return [dataclasses.replace(s, pcfg=_pcfg(tcore, seed=s.pcfg.seed, t=t, eval_every=2),
                                checkpoint_path=str(tmp_path / f"{s.name}.ckpt"),
                                checkpoint_every=2, resume=resume)
            for s in _specs(port, n=2)]


def test_pool_checkpoint_resume(port, tmp_path):
    """A pool stopped after its round-1 checkpoints resumes (in a pool) to
    the uninterrupted solo run; the checkpoint names its job."""
    _run(_ckpt_specs(port, tmp_path, False, t=2), block=2)
    _, meta = load_checkpoint(str(tmp_path / "job0.ckpt"))
    assert meta["job"] == "job0" and meta["round"] == 1 and "rng_state" in meta
    pooled = _run(_ckpt_specs(port, tmp_path, True), block=2)
    for s in _ckpt_specs(port, tmp_path, False):
        solo = _solo(dataclasses.replace(s, checkpoint_path=None), 2)
        assert [r["round"] for r in pooled[s.name].rounds] == [2, 3]
        assert pooled[s.name].rounds == solo.rounds[2:]


@pytest.mark.parametrize("first", ["pool", "solo"])
def test_checkpoint_crosses_pool_and_solo(port, tmp_path, first):
    """A job checkpointed in the pool resumes under ``run_pigeon``, and a
    solo checkpoint resumes in the pool: the tail equals the uninterrupted
    run."""
    short = _ckpt_specs(port, tmp_path, False, t=2)
    full = _ckpt_specs(port, tmp_path, True)
    if first == "pool":
        _run(short, block=2)
        tails = {s.name: _solo(s, 2, checkpoint_path=s.checkpoint_path,
                               checkpoint_every=2, resume=True) for s in full}
    else:
        for s in short:
            _solo(s, 2, checkpoint_path=s.checkpoint_path, checkpoint_every=2)
        tails = _run(full, block=2)
    for s in full:
        solo = _solo(s, 2)
        assert tails[s.name].rounds == solo.rounds[2:]


def test_pool_terminal_resume(port, tmp_path):
    """A job whose checkpoint covers its last round returns the restored
    state's record, as a solo resume does, beside a job that trains."""
    specs = _ckpt_specs(port, tmp_path, False, t=2)
    _run(specs, block=2)
    done = dataclasses.replace(specs[0], resume=True)
    fresh = dataclasses.replace(specs[1], checkpoint_path=None)
    with pytest.warns(UserWarning, match="nothing left to train"):
        pooled = _run([done, fresh], block=2)
    with pytest.warns(UserWarning, match="nothing left to train"):
        solo = _solo(done, 2, checkpoint_path=done.checkpoint_path, checkpoint_every=2,
                     resume=True)
    assert pooled["job0"].rounds == solo.rounds
    assert pooled["job0"].rounds[0]["resumed_terminal"]
    assert_history_identical(pooled["job1"], _solo(fresh, 2))


def test_job_checkpoint_metadata_layout():
    snap = {"rng_state": {"x": 1}, "seed_gen": [1], "param_gen": [2],
            "param_gen_device": "cpu"}
    assert job_checkpoint_metadata(3, snap) == {"round": 3, **snap}
    assert job_checkpoint_metadata(3, snap, job="a") == {"round": 3, **snap, "job": "a"}


# ---------------------------------------------------------------------------
# telemetry: job-tagged round events mirror the solo events
# ---------------------------------------------------------------------------

def test_pool_round_events_match_solo(port):
    specs = _specs(port, n=2, t=4)
    mem_pool = MemorySink()
    _run(specs, block=2, telemetry=Telemetry(sinks=(mem_pool,)))
    pool_rounds = mem_pool.of("round")
    for s in specs:
        mem_solo = MemorySink()
        tcore.run_pigeon(s.module, s.data, s.pcfg, engine="batched", block=2, device="cpu",
                         telemetry=Telemetry(sinks=(mem_solo,)))
        mine = [e for e in pool_rounds if e.get("job") == s.name]
        solo = mem_solo.of("round")
        assert len(mine) == len(solo) == s.pcfg.T
        for ep, es in zip(mine, solo):
            for k in ("t", "selected", "accepted", "detections", "val_losses", "comm"):
                assert ep[k] == es[k], k
    blocks = mem_pool.of("pool_block")
    assert blocks and blocks[0]["lanes"] == 2
    assert blocks[-1]["jobs_done"] == len(specs)


# ---------------------------------------------------------------------------
# the runner entry
# ---------------------------------------------------------------------------

def test_pool_accept_block_masks_idle_lanes(port):
    """An idle lane trains its placeholder but commits nothing (so its
    second round trains from theta again); an active lane's fetch rows and
    theta equal its solo ``accept_block``'s."""
    import copy
    from repro_torch.adversary import AttackVec
    from repro_torch.core.engine import assemble_block
    data, module = port
    pcfg = _pcfg(tcore, 0)
    tm = tcore.ThreatModel.from_legacy({1}, tcore.Attack(tcore.LABEL_FLIP))
    runner = trunner.protocol_accept_runner(module, pcfg.lr, tcore.resolve_policy("argmin"),
                                            True, 1e-4)
    _, (xs, ys, avecs, seeds) = assemble_block(np.random.default_rng(0),
                                               torch.Generator().manual_seed(5), data, pcfg,
                                               tm, 0, 2, torch.device("cpu"))
    theta = module.init(torch.Generator().manual_seed(0))
    solo, lanes = copy.deepcopy(theta), [copy.deepcopy(theta), copy.deepcopy(theta)]
    val = (torch.from_numpy(data.x0), torch.from_numpy(data.y0))
    solo, f_solo = runner.accept_block(solo, list(zip(xs, ys, avecs, seeds)), val)
    pool_in = (torch.stack([xs, xs]), torch.stack([ys, ys]),
               tuple(AttackVec.cat([a, a]) for a in avecs), np.stack([seeds, seeds]))
    lanes, f_pool = runner.pool_accept_block(lanes, tjobs.pool_rounds(pool_in),
                                             tuple(torch.stack([v, v]) for v in val),
                                             torch.tensor([True, False]))
    assert f_pool.shape == (2, 2, 2 * pcfg.R + 3)
    assert torch.equal(f_pool[0], f_solo) and torch.equal(f_pool[1, 0], f_solo[0])
    for half in range(2):
        for p_solo, p_act, p_idle, p0 in zip(solo[half].parameters(),
                                             lanes[0][half].parameters(),
                                             lanes[1][half].parameters(),
                                             theta[half].parameters()):
            assert torch.equal(p_act, p_solo) and torch.equal(p_idle, p0)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _mixed(core, module, data, t=(3, 4, 3)):
    return [core.jobs.JobSpec(name=f"job{s}", module=module, data=data,
                              pcfg=_pcfg(core, s, t=t[s], eval_every=2),
                              **(dict(malicious={1}, attack=core.Attack(core.LABEL_FLIP))
                                 if s % 2 else {}))
            for s in range(len(t))]


@pytest.fixture(scope="module")
def reference_pool(tiny_task):
    data, module = tiny_task
    return jjobs.run_job_pool(_mixed(jcore, module, data), block=2, lanes=2)


def test_pool_matches_reference(port, reference_pool):
    data, module = port
    pooled = _run(_mixed(tcore, module, data), block=2, lanes=2)
    assert pooled.keys() == reference_pool.keys()
    for name, hj in reference_pool.items():
        ht = pooled[name]
        assert len(ht.rounds) == len(hj.rounds)
        for rt, rj in zip(ht.rounds, hj.rounds):
            assert rt.keys() == rj.keys()
            for k in DISCRETE:
                assert rt[k] == rj[k], (name, rt["round"], k, rt[k], rj[k])
            for k in ("val_losses", "train_losses", "test_acc"):
                if k in rj:
                    np.testing.assert_allclose(rt[k], rj[k], rtol=1e-4, atol=0)


def test_plan_pool_matches_reference(port, tiny_task):
    """The schedule is the reference's: the same lanes, first rounds and
    block lengths; a sync round only ever ends a block; every round of
    every job covered once, in order."""
    data, module = port
    jdata, jmodule = tiny_task
    states, jstates = [], []
    for ts, js in zip(_mixed(tcore, module, data, t=(3, 4, 5)),
                      _mixed(jcore, jmodule, jdata, t=(3, 4, 5))):
        states.append(tjobs._init_job(ts, *tjobs.validate_job(ts), torch.device("cpu")))
        jstates.append(jjobs._init_job(js, *jjobs.validate_job(js)))
    for lanes, block in ((2, 2), (1, 3), (3, 4)):
        plans = tjobs.plan_pool(states, [0, 1, 2], lanes=lanes, block=block)
        jplans = jjobs.plan_pool(jstates, [0, 1, 2], lanes=lanes, block=block)
        assert [(p.assign, p.t0s, p.k) for p in plans] == \
               [(p.assign, p.t0s, p.k) for p in jplans]
        seen = {i: [] for i in range(3)}
        for plan in plans:
            for lane, j in enumerate(plan.assign):
                if j >= 0:
                    assert not any(states[j].is_sync(plan.t0s[lane] + dt)
                                   for dt in range(plan.k - 1))
                    seen[j].extend(range(plan.t0s[lane], plan.t0s[lane] + plan.k))
        assert all(seen[i] == list(range(st.pcfg.T)) for i, st in enumerate(states))


# ---------------------------------------------------------------------------
# bucketing and validation
# ---------------------------------------------------------------------------

def test_bucket_rules(port):
    data, module = port
    base = tjobs.JobSpec(name="a", module=module, data=data, pcfg=_pcfg(tcore, 0))
    same = [dataclasses.replace(base, name="seed", pcfg=_pcfg(tcore, 7)),
            dataclasses.replace(base, name="horizon", pcfg=_pcfg(tcore, 0, t=9)),
            dataclasses.replace(base, name="attacked", malicious={1},
                                attack=tcore.Attack(tcore.LABEL_FLIP))]
    for other in same:
        assert tjobs.bucket_key(base) == tjobs.bucket_key(other), other.name
    diff = [dataclasses.replace(base, name="batch",
                                pcfg=dataclasses.replace(_pcfg(tcore, 0), B=8)),
            dataclasses.replace(base, name="lr",
                                pcfg=dataclasses.replace(_pcfg(tcore, 0), lr=0.01)),
            dataclasses.replace(base, name="quant", quant="int8"),
            dataclasses.replace(base, name="policy", selection="median_of_means")]
    for other in diff:
        assert tjobs.bucket_key(base) != tjobs.bucket_key(other), other.name
    assert len(tjobs.JobPool([base] + same + diff).buckets()) == 1 + len(diff)


def test_pool_validation_errors(port):
    data, module = port
    base = tjobs.JobSpec(name="a", module=module, data=data, pcfg=_pcfg(tcore, 0))
    with pytest.raises(ValueError, match="duplicate job names"):
        tjobs.JobPool([base, dataclasses.replace(base)])
    with pytest.raises(ValueError, match="empty job pool"):
        tjobs.JobPool([])
    with pytest.raises(ValueError, match="not divisible"):
        tjobs.validate_job(dataclasses.replace(
            base, pcfg=dataclasses.replace(_pcfg(tcore, 0), M=5)))
    with pytest.raises(ValueError, match="param-tamper"):
        tjobs.validate_job(dataclasses.replace(base, malicious={1},
                                               attack=tcore.Attack(tcore.PARAM_TAMPER)))
    with pytest.raises(NotImplementedError, match="multi-card"):
        tjobs.run_job_pool([base], placement="sharded", device="cpu")
