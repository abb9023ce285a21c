"""Telemetry in the port: spans, sinks, sessions, provenance, the
``torch.profiler`` window, and the drivers' events — on the CPU.

Held against the reference where the two emit the same thing (event kinds
and their fields, the console line, round gauges), and against the port
itself: a run with telemetry on gives the History of the run with it off,
in every execution mode; block runs emit one round event a round, with the
per-round run's payload."""
import dataclasses
import io
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import repro.telemetry as jtel
import repro_torch.core as tcore
from repro_torch.convert import from_reference
from repro_torch.data import RoundFeeder, build_image_task
from repro_torch.launch.steps import instrument_step
from repro_torch.telemetry import (DISABLED, NULL_SESSION, ConsoleSink, JSONLSink,
                                   MemorySink, MetricsRegistry, ProfileHook, Stopwatch,
                                   Telemetry, Tracer, jit_cache_stats,
                                   pool_gauges, provenance, read_jsonl, resolve_telemetry,
                                   round_gauges)
from repro_torch.telemetry.sinks import materialize
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
LF = dict(malicious={1}, attack=tcore.Attack(tcore.LABEL_FLIP))


@pytest.fixture(scope="module")
def port(tiny_task, tiny_pcfg):
    _, jmod = tiny_task
    data, cfg = build_image_task("mnist", **TASK)
    _, k0 = jax.random.split(jax.random.PRNGKey(tiny_pcfg.seed))
    jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
    theta = from_reference(cfg, jg, jp)
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: theta)
    fields = {f.name: getattr(tiny_pcfg, f.name)
              for f in dataclasses.fields(tcore.ProtocolConfig)}
    fields["comm"] = tcore.CommConfig(tiny_pcfg.comm.quant)
    return data, module, tcore.ProtocolConfig(**fields)


# ---------------------------------------------------------------------------
# spans, sinks, sessions
# ---------------------------------------------------------------------------

def test_stopwatch_elapsed_nonnegative():
    with Stopwatch() as sw:
        sum(range(1000))
    assert sw.elapsed >= 0.0


def test_span_nesting_paths_and_depth_match_reference():
    def run(tracer_cls):
        events = []
        tr = tracer_cls(events.append)
        with tr.span("round", round=3):
            with tr.span("step") as sp:
                sp.fence(torch.zeros(2), [torch.ones(1)], {"a": torch.zeros(1)})
            with tr.span("fetch"):
                pass
        return [(e["name"], e["path"], e["depth"], e.get("round")) for e in events]

    assert run(Tracer) == run(jtel.Tracer) == [
        ("step", "round/step", 1, None), ("fetch", "round/fetch", 1, None),
        ("round", "round", 0, 3)]


def test_span_error_annotated():
    events = []
    with pytest.raises(KeyError):
        with Tracer(events.append).span("boom"):
            raise KeyError("x")
    assert events[0]["error"] == "KeyError" and events[0]["dur_s"] >= 0


def test_spans_nest_independently_per_thread():
    events, tr = [], Tracer(lambda e: events.append(e))
    barrier = threading.Barrier(2)

    def work(name):
        with tr.span(name):
            barrier.wait(timeout=5)
            with tr.span("inner"):
                pass

    threads = [threading.Thread(target=work, args=(n,), name=n) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    inner = sorted(e["path"] for e in events if e["name"] == "inner")
    assert inner == ["a/inner", "b/inner"]


def test_cpu_fence_records_no_event():
    span = Tracer(lambda e: None).span("s")
    span.fence(torch.zeros(3), (torch.ones(2),))
    assert span._events == []


def test_jsonl_roundtrip_and_torn_write_tolerance(tmp_path):
    path = str(tmp_path / "t.jsonl")
    sink = JSONLSink(path)
    sink.emit({"event": "a", "v": np.float32(1.5), "arr": np.arange(3),
               "t": torch.tensor([1.0, 2.0]), "s": torch.tensor(4)})
    sink.close()
    with open(path, "a") as f:
        f.write('{"event": "torn"')               # a crash mid-line
    sink = JSONLSink(path)                        # heals the tail
    sink.emit({"event": "b"})
    sink.close()
    events = read_jsonl(path)
    assert [e["event"] for e in events] == ["a", "b"]
    assert events[0]["v"] == 1.5 and events[0]["arr"] == [0, 1, 2]
    assert events[0]["t"] == [1.0, 2.0] and events[0]["s"] == 4
    assert jtel.read_jsonl(path) == events        # the reference reads the port's log


def test_materialize_refuses_device_tensors():
    assert materialize({"x": (np.int64(3), [np.array(2.0)])}) == {"x": [3, [2.0]]}
    meta = torch.empty(2, device="meta")
    with pytest.raises(TypeError, match="fetch it"):
        materialize({"x": meta})


def test_console_sink_round_line_matches_reference():
    event = {"event": "round", "run": "pigeon", "t": 2, "test_acc": 0.5, "selected": 1,
             "selected_honest": True, "accepted": True, "detections": 0,
             "val_losses": [2.3, 2.25]}
    mine, theirs = io.StringIO(), io.StringIO()
    ConsoleSink(mine).emit(event)
    jtel.ConsoleSink(theirs).emit(event)
    assert mine.getvalue() == theirs.getvalue()
    assert mine.getvalue().startswith("[pigeon] t=  2 acc=0.5000 sel=1")
    ConsoleSink(mine).emit({"event": "span"})     # only round events print
    assert mine.getvalue() == theirs.getvalue()


def test_memory_sink_filters_by_kind():
    mem = MemorySink()
    for e in ({"event": "a"}, {"event": "b"}, {"event": "a", "x": 1}):
        mem.emit(e)
    assert [e.get("x") for e in mem.of("a")] == [None, 1]


def test_resolve_disabled_returns_shared_null():
    assert resolve_telemetry(None) is NULL_SESSION
    assert resolve_telemetry(DISABLED) is NULL_SESSION
    assert resolve_telemetry(NULL_SESSION) is NULL_SESSION


def test_resolve_verbose_is_console_alias(capsys):
    tel = resolve_telemetry(None, verbose=True, run="x")
    tel.record_round(0, {"selected": 1, "test_acc": 0.25})
    tel.close()
    assert "[x] t=  0 acc=0.2500 sel=1" in capsys.readouterr().out


def test_resolve_borrowed_session_survives_driver_close():
    mem = MemorySink()
    session = Telemetry(sinks=(mem,)).session("outer")
    borrowed = resolve_telemetry(session)
    borrowed.close()
    borrowed.emit({"event": "after"})
    assert mem.of("after") and not mem.of("run_end")
    session.close()
    session.close()                               # idempotent
    assert len(mem.of("run_end")) == 1


def test_session_close_emits_metrics_and_null_session_is_inert():
    mem = MemorySink()
    s = Telemetry(sinks=(mem,), spans=False).session("r")
    s.record_round(0, {"accepted": True, "detections": 2, "selected_honest": True})
    with s.span("ignored") as sp:
        sp.fence(torch.zeros(1))
    s.close()
    counters = mem.of("run_end")[0]["metrics"]["counters"]
    assert counters == {"rounds": 1, "rounds_accepted": 1, "detections": 2,
                        "honest_selections": 1}
    assert not mem.of("span")
    with NULL_SESSION.span("x") as sp:
        sp.fence(torch.zeros(1))
    NULL_SESSION.record_round(0, {})
    NULL_SESSION.profile_tick(0)
    NULL_SESSION.close()


def test_round_and_pool_gauges_match_reference():
    rec = {"round": 3, "selected": 1, "accepted": False, "detections": 2,
           "selected_honest": False, "val_losses": [1.0, 2.0], "comm": {"a": 1},
           "clusters": [[0, 1]], "other": 5}
    assert round_gauges(rec, 2) == jtel.round_gauges(rec, 2)
    assert round_gauges(rec) == jtel.round_gauges(rec)
    assert pool_gauges({"j": 0}, 4, 2, 1, 3) == jtel.pool_gauges({"j": 0}, 4, 2, 1, 3)
    reg, jreg = MetricsRegistry(), jtel.MetricsRegistry()
    for r in (rec, {"accepted": True}):
        reg.observe_round(r)
        jreg.observe_round(r)
    assert reg.snapshot() == jreg.snapshot()


def test_provenance_stamp_keys():
    p = provenance(extra=1)
    for k in ("python", "cpu_count", "git_sha", "torch", "cuda", "cudnn", "backend",
              "device_kind", "device_count", "gpus", "timestamp", "timestamp_utc"):
        assert k in p, k
    assert p["extra"] == 1 and p["backend"] in ("cpu", "cuda")
    json.dumps(p)
    assert "jax" not in p


def test_jit_cache_stats_reports_the_kernel_libraries():
    stats = jit_cache_stats()
    assert set(stats) == {"libraries", "build_seconds", "launches", "persistent_cache_dir",
                          "persistent_cache_entries", "persistent_cache_hits",
                          "persistent_cache_misses"}
    assert "tamper_check_sums" in stats["launches"]


def test_profile_hook_writes_a_trace_for_its_window(tmp_path):
    hook = ProfileHook(str(tmp_path / "prof"), rounds=(1, 2))
    for t in range(3):
        hook.tick(t)
        torch.ones(64).sum()
    hook.close()
    files = os.listdir(tmp_path / "prof")
    assert files == ["trace_1_2.json"]
    with open(tmp_path / "prof" / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_instrument_step_passthrough_and_spans():
    def step(x):
        return x + 1

    assert instrument_step(step, None, "s") is step
    assert instrument_step(step, NULL_SESSION, "s") is step
    mem = MemorySink()
    session = Telemetry(sinks=(mem,)).session("serve")
    traced = instrument_step(step, session, "serve.decode")
    assert [traced(torch.tensor(i)).item() for i in range(3)] == [1, 2, 3]
    session.close()
    assert [(s["name"], s["call"]) for s in mem.of("span")] == [
        ("serve.decode", 0), ("serve.decode", 1), ("serve.decode", 2)]


def test_feeder_qsize_gauge():
    with RoundFeeder(lambda t: t * 10, start=0, stop=0, depth=1) as f:
        assert f.qsize() == 0
    with RoundFeeder(lambda t: t * 10, start=0, stop=4, depth=0) as f:
        assert f.qsize() == 0 and f.get(0) == 0


# ---------------------------------------------------------------------------
# the drivers: events mirror the History, which telemetry does not change
# ---------------------------------------------------------------------------

def test_round_events_mirror_history(port):
    data, module, pcfg = port
    mem = MemorySink()
    h = tcore.run_pigeon(module, data, pcfg, engine="batched", prefetch=1, device="cpu",
                         telemetry=Telemetry(sinks=(mem,)), **LF)
    rounds = mem.of("round")
    assert len(rounds) == len(h.rounds) == pcfg.T
    for ev, rec in zip(rounds, h.rounds):
        assert ev["t"] == rec["round"]
        for k in ("selected", "accepted", "detections", "selected_honest", "val_losses",
                  "comm"):
            assert ev[k] == rec[k], k
        assert ev["feeder_depth"] >= 0
    names = {s["name"] for s in mem.of("span")}
    assert {"feeder.assemble", "round.feeder_wait", "round.step", "round.fetch",
            "round.eval"} <= names
    start = mem.of("run_start")[0]
    assert start["prefetch"] == 1 and start["device"] == "cpu"
    assert start["provenance"]["backend"] in ("cpu", "cuda")


def test_trace_jsonl_from_a_three_round_run(port, tmp_path):
    data, module, pcfg = port
    path = str(tmp_path / "run.jsonl")
    tcore.run_pigeon(module, data, dataclasses.replace(pcfg, T=3), engine="batched",
                     prefetch=1, device="cpu", telemetry=Telemetry(jsonl=path,
                                                                   jit_stats=True))
    evs = read_jsonl(path)
    assert evs[0]["event"] == "run_start" and "git_sha" in evs[0]["provenance"]
    assert evs[-1]["event"] == "run_end"
    rounds = [e for e in evs if e["event"] == "round"]
    assert [r["t"] for r in rounds] == [0, 1, 2]
    assert set(rounds[0]["jit"]) == {"libraries", "build_seconds", "launches",
                                     "persistent_cache_dir", "persistent_cache_entries",
                                     "persistent_cache_hits", "persistent_cache_misses"}


def assert_history_identical(h_on, h_off):
    assert len(h_on.rounds) == len(h_off.rounds)
    for a, b in zip(h_on.rounds, h_off.rounds):
        assert a == b


@pytest.mark.parametrize("engine,prefetch,block", [
    ("sequential", 0, 1), ("batched", 0, 1), ("batched", 1, 1), ("batched", 0, 2),
    ("batched", 1, 2)])
def test_bit_identity_pigeon(port, tmp_path, engine, prefetch, block):
    data, module, pcfg = port
    pcfg = dataclasses.replace(pcfg, T=3, eval_every=3 if block > 1 else 1)
    kw = dict(engine=engine, prefetch=prefetch, block=block, device="cpu", **LF)
    tel = Telemetry(sinks=(MemorySink(),), jit_stats=True, jsonl=str(tmp_path / "t.jsonl"),
                    profile_dir=str(tmp_path / "prof"))
    assert_history_identical(tcore.run_pigeon(module, data, pcfg, telemetry=tel, **kw),
                             tcore.run_pigeon(module, data, pcfg, **kw))


@pytest.mark.parametrize("engine,prefetch,block", [
    ("sequential", 0, 1), ("batched", 1, 1), ("batched", 0, 2)])
def test_bit_identity_splitfed(port, engine, prefetch, block):
    data, module, pcfg = port
    pcfg = dataclasses.replace(pcfg, T=3, eval_every=3)
    kw = dict(engine=engine, prefetch=prefetch, block=block, device="cpu", **LF)
    mem = MemorySink()
    h_on = tcore.run_splitfed(module, data, pcfg, telemetry=Telemetry(sinks=(mem,)), **kw)
    assert_history_identical(h_on, tcore.run_splitfed(module, data, pcfg, **kw))
    assert [e["t"] for e in mem.of("round")] == [0, 1, 2]


def test_bit_identity_vanilla_and_via_protocol_config(port, capsys):
    data, module, pcfg = port
    mem = MemorySink()
    on_cfg = dataclasses.replace(pcfg, telemetry=Telemetry(sinks=(mem,)))
    h_on = tcore.run_vanilla_sl(module, data, on_cfg, verbose=True, device="cpu", **LF)
    assert_history_identical(h_on, tcore.run_vanilla_sl(module, data, pcfg, device="cpu",
                                                        **LF))
    assert [e["t"] for e in mem.of("round")] == list(range(pcfg.T))
    assert {s["name"] for s in mem.of("span")} == {"round.step", "round.eval"}
    assert "[vanilla] t=  0" in capsys.readouterr().out


def test_block_round_events_mirror_per_round(port):
    data, module, pcfg = port
    pcfg = dataclasses.replace(pcfg, T=4, eval_every=10)
    kw = dict(engine="batched", device="cpu", **LF)
    mem_1, mem_4 = MemorySink(), MemorySink()
    tcore.run_pigeon(module, data, pcfg, telemetry=Telemetry(sinks=(mem_1,)), **kw)
    tcore.run_pigeon(module, data, pcfg, telemetry=Telemetry(sinks=(mem_4,)), block=4,
                     **kw)
    r1, r4 = mem_1.of("round"), mem_4.of("round")
    assert [e["t"] for e in r4] == [e["t"] for e in r1] == list(range(pcfg.T))
    for e1, e4 in zip(r1, r4):
        for k in ("selected", "accepted", "detections", "selected_honest", "val_losses",
                  "comm"):
            assert e1[k] == e4[k], k
    spans = mem_4.of("span")
    assert {"block.assemble", "block.step", "block.fetch"} <= {s["name"] for s in spans}
    assert [s["k"] for s in spans if s["name"] == "block.fetch"] == [1, 3]
    assert mem_4.of("run_start")[0]["block"] == 4
