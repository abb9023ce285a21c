"""Multi-round execution in the port: the round feeder, round blocks and
their planning, ``check_block``, and the block and prefetch paths of
``run_pigeon`` and ``run_splitfed`` on the batched engine, on the CPU.

Held two ways, on the tiny fixtures (``conftest.tiny_task`` / ``tiny_pcfg``):
  * against the port itself: ``block=K``, ``prefetch`` and both together
    give a History float-equal to ``block=1`` (every key, CommMeter included);
  * against the reference: the port's ``block=K`` run has the reference's
    ``block=K`` discrete outcomes (clusters, selections, detections,
    acceptance, comm) under the deterministic attack families, and its
    losses within rtol 1e-4.
"""
import copy
import dataclasses
import threading
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.protocol import check_block as jax_check_block
from repro.data.pipeline import lane_block_len as jax_lane_block_len
from repro.data.pipeline import plan_blocks as jax_plan_blocks
from repro.selection import unpack_block_fetch as jax_unpack_block_fetch
import repro_torch.core as tcore
from repro_torch.convert import from_reference
from repro_torch.core import engine as tengine
from repro_torch.core import runner as trunner
from repro_torch.core.protocol import check_block
from repro_torch.data import RoundFeeder, build_image_task, lane_block_len, plan_blocks
from repro_torch.selection import resolve_policy, unpack_block_fetch
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")


def _block_pcfg(pcfg, **kw):
    """Four rounds with eval past T, so a block can span several rounds."""
    kw.setdefault("T", 4)
    kw.setdefault("eval_every", 10)
    return dataclasses.replace(pcfg, **kw)


@pytest.fixture(scope="module")
def port(tiny_task, tiny_pcfg):
    """The port's task, its module carrying the reference's initial
    parameters for ``tiny_pcfg.seed``, and its ProtocolConfig."""
    _, jmod = tiny_task
    data, cfg = build_image_task("mnist", **TASK)
    _, k0 = jax.random.split(jax.random.PRNGKey(tiny_pcfg.seed))
    jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
    theta = from_reference(cfg, jg, jp)
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: theta)
    fields = {f.name: getattr(tiny_pcfg, f.name)
              for f in dataclasses.fields(tcore.ProtocolConfig) if f.name != "telemetry"}
    fields["comm"] = tcore.CommConfig(tiny_pcfg.comm.quant)
    return data, module, tcore.ProtocolConfig(**fields)


def assert_rounds_identical(h_a, h_b):
    """Every History key equal, floats bit for bit."""
    assert len(h_a.rounds) == len(h_b.rounds)
    for ra, rb in zip(h_a.rounds, h_b.rounds):
        assert ra.keys() == rb.keys(), set(ra) ^ set(rb)
        for k in ra:
            assert ra[k] == rb[k], (ra.get("round"), k, ra[k], rb[k])


def assert_matches_reference(ht, hj, rtol=1e-4):
    assert len(ht.rounds) == len(hj.rounds)
    for rt, rj in zip(ht.rounds, hj.rounds):
        for k in DISCRETE:
            if k in rj:
                assert rt[k] == rj[k], (rt["round"], k, rt[k], rj[k])
        np.testing.assert_allclose(rt["val_losses"], rj["val_losses"], rtol=rtol, atol=0)
        assert ("test_acc" in rt) == ("test_acc" in rj)
        if "test_acc" in rj:
            np.testing.assert_allclose(rt["test_acc"], rj["test_acc"], rtol=rtol, atol=0)


LF = dict(malicious={1}, attack=tcore.Attack(tcore.LABEL_FLIP))
JLF = dict(malicious={1}, attack=jcore.Attack(jcore.LABEL_FLIP))


# ---------------------------------------------------------------------------
# the round feeder
# ---------------------------------------------------------------------------

def test_round_feeder_orders_and_bounds():
    produced = []

    def make_round(t):
        produced.append(t)
        return t * 10

    feeder = RoundFeeder(make_round, 0, 6, depth=1)
    try:
        for t in range(6):
            assert feeder.get(t) == t * 10
    finally:
        feeder.close()
    assert produced == list(range(6))       # strictly ascending: the streams' order


def test_round_feeder_rejects_out_of_order_and_propagates_errors():
    def boom(t):
        if t == 1:
            raise RuntimeError("assembly failed")
        return t

    feeder = RoundFeeder(boom, 0, 3, depth=2)
    try:
        assert feeder.get(0) == 0
        with pytest.raises(RuntimeError, match="assembly failed"):
            feeder.get(1)
    finally:
        feeder.close()
    feeder = RoundFeeder(lambda t: t, 0, 3, depth=1)
    try:
        with pytest.raises(RuntimeError, match="out of order"):
            feeder.get(2)
    finally:
        feeder.close()


def test_round_feeder_close_unblocks_producer():
    started = threading.Event()

    def make_round(t):
        started.set()
        return t

    feeder = RoundFeeder(make_round, 0, 1000, depth=1)
    started.wait(timeout=5)
    feeder.close()                           # producer blocked on a full queue
    feeder.close()                           # idempotent
    assert feeder._thread is None


def test_round_feeder_depth_zero_is_synchronous():
    calls = []
    feeder = RoundFeeder(lambda t: calls.append(t) or t, 0, 4, depth=0)
    assert feeder.get(0) == 0
    assert calls == [0]                      # nothing assembled ahead
    assert feeder.get(1) == 1
    assert feeder.qsize() == 0
    feeder.close()


# ---------------------------------------------------------------------------
# planning and validation, against the reference
# ---------------------------------------------------------------------------

def test_plan_blocks_tiles_and_respects_sync():
    segs = plan_blocks(0, 10, 4, lambda t: t % 5 == 0 or t == 9)
    assert segs == [(0, 1), (1, 4), (5, 1), (6, 4)]
    assert plan_blocks(3, 3, 4) == []
    assert plan_blocks(0, 5, 1) == [(t, 1) for t in range(5)]
    with pytest.raises(ValueError):
        plan_blocks(0, 5, 0)


@pytest.mark.parametrize("start,stop,block,every", [
    (0, 5, 4, 5), (0, 12, 3, 4), (2, 9, 4, 3), (0, 7, 8, 100), (1, 6, 2, 1)])
def test_plan_blocks_and_lane_block_len_match_reference(start, stop, block, every):
    def sync(t):
        return t % every == 0 or t == stop - 1

    assert plan_blocks(start, stop, block, sync) == jax_plan_blocks(start, stop, block, sync)
    for t in range(start, stop):
        assert lane_block_len(t, stop, block, sync) == jax_lane_block_len(t, stop, block,
                                                                          sync)


def test_unpack_block_fetch_matches_reference():
    rng = np.random.default_rng(0)
    r = 3
    rows = np.concatenate([rng.normal(size=(4, 2 * r)),
                           np.array([[1, 0, 1], [2, 1, 1], [0, 3, 0], [1, 2, 1]])],
                          axis=1).astype(np.float32)
    got, want = list(unpack_block_fetch(rows, r)), list(jax_unpack_block_fetch(rows, r))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
    with pytest.raises(ValueError):
        list(unpack_block_fetch(rows[0], r))


def test_check_block_validation(port):
    data, module, pcfg = port
    with pytest.raises(ValueError, match="block=0"):
        check_block(0)
    with pytest.raises(ValueError, match="engine"):
        check_block(2, "sequential")
    with pytest.raises(ValueError, match="checkpoint_every"):
        check_block(2, checkpoint_every=0)
    with pytest.raises(ValueError, match="block"):
        tcore.run_pigeon(module, data, pcfg, engine="sequential", block=2, device="cpu")
    for forced in (dict(plus=True), dict(has_param_tamper=True),
                   dict(force_host_selection=True)):
        with pytest.warns(UserWarning):
            assert check_block(4, **forced) == 1
    with pytest.warns(UserWarning):               # every round is a sync round
        assert check_block(4, eval_every=1) == 4
    with pytest.warns(UserWarning, match="checkpoint_every=1"):
        assert check_block(4, eval_every=5, checkpoint_path="c") == 4
    assert check_block(1, plus=True) == 1         # block=1 never warns


@pytest.mark.parametrize("kw", [
    dict(), dict(plus=True), dict(has_param_tamper=True), dict(force_host_selection=True),
    dict(eval_every=1), dict(eval_every=4), dict(eval_every=4, checkpoint_path="c"),
    dict(eval_every=4, checkpoint_path="c", checkpoint_every=3)])
def test_check_block_returns_the_references_block(kw):
    with warnings.catch_warnings(record=True) as mine:
        warnings.simplefilter("always")
        got = check_block(4, **kw)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        want = jax_check_block(4, **kw)
    assert got == want
    assert len(mine) == len(theirs)


# ---------------------------------------------------------------------------
# prefetch and blocks: float-equal to block=1, the reference's outcomes
# ---------------------------------------------------------------------------

def test_prefetch_history_bit_identical(port):
    data, module, pcfg = port
    kw = dict(engine="batched", device="cpu", **LF)
    h_sync = tcore.run_pigeon(module, data, pcfg, **kw)
    assert_rounds_identical(h_sync, tcore.run_pigeon(module, data, pcfg, prefetch=1, **kw))
    assert_rounds_identical(h_sync, tcore.run_pigeon(module, data, pcfg, prefetch=2, **kw))


def test_prefetch_plus_phase_boundary_fallback(port):
    """Pigeon-SL+ sub-rounds sample the selected cluster: prefetch is
    accepted and runs synchronously."""
    data, module, pcfg = port
    kw = dict(engine="batched", device="cpu", **LF)
    assert_rounds_identical(tcore.run_pigeon_plus(module, data, pcfg, **kw),
                            tcore.run_pigeon_plus(module, data, pcfg, prefetch=2, **kw))


def test_prefetch_host_selected_path(port):
    """The batched host cascade takes the feeder's payloads too."""
    data, module, pcfg = port
    kw = dict(engine="batched", device="cpu", _force_host_selection=True, **LF)
    h = tcore.run_pigeon(module, data, pcfg, **kw)
    assert_rounds_identical(h, tcore.run_pigeon(module, data, pcfg, prefetch=1, **kw))
    h_fused = tcore.run_pigeon(module, data, pcfg, engine="batched", device="cpu", **LF)
    for a, b in zip(h.rounds, h_fused.rounds):
        assert {k: a[k] for k in DISCRETE} == {k: b[k] for k in DISCRETE}


@pytest.mark.parametrize("malicious,attack,tamper_check", [
    (set(), tcore.NONE, False),
    ({1}, tcore.LABEL_FLIP, False),
    ({1}, tcore.LABEL_FLIP, True),
], ids=["honest", "label_flip", "label_flip+tamper_check"])
def test_block_history_bit_identical_and_matches_reference(port, tiny_task, tiny_pcfg,
                                                           malicious, attack,
                                                           tamper_check):
    data, module, pcfg = port
    pcfg = _block_pcfg(pcfg, tamper_check=tamper_check)
    kw = dict(malicious=malicious, attack=tcore.Attack(attack), engine="batched",
              device="cpu")
    h_1 = tcore.run_pigeon(module, data, pcfg, block=1, **kw)
    h_4 = tcore.run_pigeon(module, data, pcfg, block=4, **kw)
    assert_rounds_identical(h_1, h_4)
    jdata, jmod = tiny_task
    h_j = jcore.run_pigeon(jmod, jdata, _block_pcfg(tiny_pcfg, tamper_check=tamper_check),
                           malicious=malicious, attack=jcore.Attack(attack),
                           engine="batched", block=4)
    assert_matches_reference(h_4, h_j)


def test_block_selection_policy_bit_identical(port):
    """A policy with message statistics (B3's wire, int8) rides inside each
    round of the block."""
    data, module, pcfg = port
    pcfg = _block_pcfg(pcfg)
    kw = dict(engine="batched", device="cpu", selection="loss_plus_distance",
              quant="int8", **LF)
    assert_rounds_identical(tcore.run_pigeon(module, data, pcfg, block=1, **kw),
                            tcore.run_pigeon(module, data, pcfg, block=4, **kw))


def test_block_eval_rounds_are_sync_points(port, tiny_task, tiny_pcfg):
    data, module, pcfg = port
    pcfg = _block_pcfg(pcfg, T=5, eval_every=2)
    kw = dict(engine="batched", device="cpu")
    h_1 = tcore.run_pigeon(module, data, pcfg, block=1, **kw)
    h_4 = tcore.run_pigeon(module, data, pcfg, block=4, **kw)
    assert [("test_acc" in r) for r in h_4.rounds] == [True, False, True, False, True]
    assert_rounds_identical(h_1, h_4)
    jdata, jmod = tiny_task
    h_j = jcore.run_pigeon(jmod, jdata, _block_pcfg(tiny_pcfg, T=5, eval_every=2),
                           engine="batched", block=4)
    assert_matches_reference(h_4, h_j)


def test_block_prefetch_compose(port):
    data, module, pcfg = port
    pcfg = _block_pcfg(pcfg, T=5)
    kw = dict(engine="batched", device="cpu", **LF)
    h_1 = tcore.run_pigeon(module, data, pcfg, block=1, **kw)
    for block, prefetch in ((2, 2), (4, 1)):
        assert_rounds_identical(h_1, tcore.run_pigeon(module, data, pcfg, block=block,
                                                      prefetch=prefetch, **kw))


def test_block_forced_to_one_for_pigeon_plus(port):
    data, module, pcfg = port
    pcfg = _block_pcfg(pcfg, T=2)
    kw = dict(engine="batched", device="cpu", **LF)
    with pytest.warns(UserWarning, match="forced to 1"):
        h = tcore.run_pigeon_plus(module, data, pcfg, block=4, **kw)
    assert_rounds_identical(h, tcore.run_pigeon_plus(module, data, pcfg, **kw))


def test_block_splitfed_bit_identical_and_matches_reference(port, tiny_task, tiny_pcfg):
    data, module, pcfg = port
    pcfg = _block_pcfg(pcfg)
    kw = dict(engine="batched", device="cpu", **LF)
    h_1 = tcore.run_splitfed(module, data, pcfg, block=1, **kw)
    h_4 = tcore.run_splitfed(module, data, pcfg, block=4, **kw)
    assert_rounds_identical(h_1, h_4)
    assert_rounds_identical(h_1, tcore.run_splitfed(module, data, pcfg, block=2,
                                                    prefetch=1, **kw))
    assert_rounds_identical(h_1, tcore.run_splitfed(module, data, pcfg, prefetch=2, **kw))
    jdata, jmod = tiny_task
    h_j = jcore.run_splitfed(jmod, jdata, _block_pcfg(tiny_pcfg), engine="batched",
                             block=4, **JLF)
    assert_matches_reference(h_4, h_j)


# ---------------------------------------------------------------------------
# the runner's and the engine's block entries
# ---------------------------------------------------------------------------

def test_accept_block_is_k_accepts_with_one_stacked_fetch(port):
    data, module, pcfg = port
    rng = np.random.default_rng(pcfg.seed)
    seed_gen = torch.Generator().manual_seed(0)
    tm = tcore.ThreatModel.from_legacy({1}, tcore.Attack(tcore.LABEL_FLIP))
    clusters_k, block = tengine.assemble_block(rng, seed_gen, data, pcfg, tm, 0, 3,
                                               torch.device("cpu"))
    assert block[0].shape[:3] == (3, pcfg.R, pcfg.M // pcfg.R)
    rng2 = np.random.default_rng(pcfg.seed)
    seed_gen2 = torch.Generator().manual_seed(0)
    for i in range(3):                       # the per-round order, round by round
        clusters = tcore.make_clusters(rng2, pcfg.M, pcfg.R)
        xs, ys, _, seeds = tengine.assemble_round(rng2, seed_gen2, data, clusters, pcfg,
                                                  tm, i, torch.device("cpu"))
        assert clusters == clusters_k[i]
        assert torch.equal(xs, block[0][i]) and torch.equal(ys, block[1][i])
        np.testing.assert_array_equal(seeds, block[3][i])
    runner = trunner.protocol_accept_runner(module, pcfg.lr, resolve_policy("argmin"),
                                            True, pcfg.tamper_tol)
    val = (torch.from_numpy(data.x0), torch.from_numpy(data.y0))
    theta_a = tuple(copy.deepcopy(m) for m in module.init(None))
    theta_b = tuple(copy.deepcopy(m) for m in module.init(None))
    committed, fetches = runner.accept_block(theta_a, tengine.block_rounds(block), val)
    assert fetches.shape == (3, 2 * pcfg.R + 3)
    assert committed[0] is theta_a[0]
    for i, inputs in enumerate(tengine.block_rounds(block)):
        theta_b, fetch = runner.accept(theta_b, inputs, val)
        assert torch.equal(fetch, fetches[i])
    for a, b in zip(theta_a, theta_b):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)


def test_assemble_block_out_form_returns_host_buffers(port):
    data, module, pcfg = port
    m_bar = pcfg.M // pcfg.R
    xs = np.zeros((2, pcfg.R, m_bar, pcfg.E, pcfg.B) + data.x.shape[2:], data.x.dtype)
    ys = np.zeros((2, pcfg.R, m_bar, pcfg.E, pcfg.B), data.y.dtype)
    tm = tcore.ThreatModel()
    clusters_k, (xk, yk, avecs, seeds_k) = tengine.assemble_block(
        np.random.default_rng(0), torch.Generator().manual_seed(0), data, pcfg, tm, 0, 2,
        None, out=(xs, ys))
    assert xk is xs and yk is ys and len(avecs) == 2 and seeds_k.shape == (2, pcfg.R, m_bar)
    assert np.abs(xs).sum() > 0 and all(a.code.device.type == "cpu" for a in avecs)
