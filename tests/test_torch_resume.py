"""Checkpoint and resume in the port: on-stream resume (a run checkpointed
at round k and resumed reproduces the uninterrupted run's remaining rounds
float for float) on both engines, with Pigeon-SL+, with param tamper, with
the round feeder, in block mode and across modes; crash-atomic writes and
torn-checkpoint detection; the terminal checkpoint.

The checkpoint carries theta and the run's three random streams: the numpy
bit generator, the per-turn seed generator and the handoff-noise generator.
The same checkpoint API is held against the reference's on its own format
where the two can meet (the manifest and the token check)."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

import repro.checkpoint as jckpt
import repro_torch.checkpoint as tckpt
import repro_torch.core as tcore
from repro_torch.checkpoint import (CorruptCheckpointError, load_checkpoint,
                                    protocol_state_metadata, restore_protocol_state,
                                    restore_pytree, save_checkpoint)
from repro_torch.convert import from_reference
from repro_torch.data import build_image_task
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


def assert_tail_bit_identical(h_full, h_res, start):
    """h_res reproduces h_full.rounds[start:] with float equality."""
    assert [r["round"] for r in h_res.rounds] == [r["round"] for r in h_full.rounds[start:]]
    for ra, rb in zip(h_full.rounds[start:], h_res.rounds):
        for k in ("clusters", "selected", "val_losses", "train_losses", "comm"):
            assert ra[k] == rb[k], (ra["round"], k)
        assert ra.get("test_acc") == rb.get("test_acc")
        assert ra.get("detections") == rb.get("detections")


def _tiny_modules(seed=0):
    torch.manual_seed(seed)
    return (nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2)), nn.Linear(2, 5))


# ---------------------------------------------------------------------------
# resume: checkpoint at round t, resume, compare float for float
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("plus", [False, True], ids=["pigeon", "pigeon_plus"])
def test_resume_is_on_stream(port, tmp_path, engine, plus):
    data, module, pcfg = port
    pcfg_full = dataclasses.replace(pcfg, T=2)
    pcfg_half = dataclasses.replace(pcfg, T=1)
    path = str(tmp_path / "ck")
    kw = dict(engine=engine, plus=plus, device="cpu", **LF)
    h_full = tcore.run_pigeon(module, data, pcfg_full, **kw)
    tcore.run_pigeon(module, data, pcfg_half, checkpoint_path=path, **kw)
    h_res = tcore.run_pigeon(module, data, pcfg_full, checkpoint_path=path, resume=True,
                             **kw)
    assert_tail_bit_identical(h_full, h_res, start=1)


def test_resume_is_on_stream_param_tamper(port, tmp_path):
    """The host selector draws handoff noise from the device generator: the
    checkpoint must carry its state too."""
    data, module, pcfg = port
    pcfg_full = dataclasses.replace(pcfg, T=3)
    pcfg_half = dataclasses.replace(pcfg, T=1)
    path = str(tmp_path / "ck")
    kw = dict(malicious={0, 1, 3}, attack=tcore.Attack(tcore.PARAM_TAMPER),
              engine="batched", device="cpu")
    h_full = tcore.run_pigeon(module, data, pcfg_full, **kw)
    tcore.run_pigeon(module, data, pcfg_half, checkpoint_path=path, **kw)
    h_res = tcore.run_pigeon(module, data, pcfg_full, checkpoint_path=path, resume=True,
                             **kw)
    assert_tail_bit_identical(h_full, h_res, start=1)


def test_resume_with_prefetch_feeder_snapshot(port, tmp_path):
    """The feeder runs ahead of the loop; the checkpoint must hold the
    snapshot taken right after round t's assembly."""
    data, module, pcfg = port
    pcfg_full = dataclasses.replace(pcfg, T=3)
    pcfg_half = dataclasses.replace(pcfg, T=2)
    path = str(tmp_path / "ck")
    kw = dict(engine="batched", device="cpu", **LF)
    h_full = tcore.run_pigeon(module, data, pcfg_full, **kw)
    tcore.run_pigeon(module, data, pcfg_half, prefetch=2, checkpoint_path=path, **kw)
    h_res = tcore.run_pigeon(module, data, pcfg_full, prefetch=2, checkpoint_path=path,
                             resume=True, **kw)
    assert_tail_bit_identical(h_full, h_res, start=2)


def test_resume_block_mode_is_on_stream(port, tmp_path):
    data, module, pcfg = port
    pcfg_full = dataclasses.replace(pcfg, T=4, eval_every=10)
    pcfg_half = dataclasses.replace(pcfg, T=2, eval_every=10)
    path = str(tmp_path / "ck")
    kw = dict(engine="batched", device="cpu", **LF)
    h_full = tcore.run_pigeon(module, data, pcfg_full, **kw)          # block=1
    tcore.run_pigeon(module, data, pcfg_half, checkpoint_path=path, checkpoint_every=2,
                     block=2, **kw)
    h_res = tcore.run_pigeon(module, data, pcfg_full, checkpoint_path=path,
                             checkpoint_every=2, block=2, resume=True, **kw)
    assert_tail_bit_identical(h_full, h_res, start=2)


def test_resume_across_block_modes(port, tmp_path):
    data, module, pcfg = port
    pcfg_full = dataclasses.replace(pcfg, T=4, eval_every=10)
    pcfg_half = dataclasses.replace(pcfg, T=2, eval_every=10)
    kw = dict(engine="batched", device="cpu", **LF)
    h_full = tcore.run_pigeon(module, data, pcfg_full, **kw)
    path_b = str(tmp_path / "ck_block")        # block-written -> per-round
    tcore.run_pigeon(module, data, pcfg_half, checkpoint_path=path_b, checkpoint_every=2,
                     block=2, **kw)
    assert_tail_bit_identical(h_full, tcore.run_pigeon(
        module, data, pcfg_full, checkpoint_path=path_b, resume=True, **kw), start=2)
    path_r = str(tmp_path / "ck_round")        # per-round -> block, with prefetch
    tcore.run_pigeon(module, data, pcfg_half, checkpoint_path=path_r, **kw)
    assert_tail_bit_identical(h_full, tcore.run_pigeon(
        module, data, pcfg_full, checkpoint_path=path_r, checkpoint_every=2, block=2,
        prefetch=1, resume=True, **kw), start=2)


def test_checkpoint_every_thins_per_round_writes(port, tmp_path, monkeypatch):
    written = []
    real_save = tckpt.save_checkpoint

    def counting_save(path, tree, meta):
        written.append(meta["round"])
        return real_save(path, tree, meta)

    monkeypatch.setattr(tckpt, "save_checkpoint", counting_save)
    data, module, pcfg = port
    pcfg = dataclasses.replace(pcfg, T=4, eval_every=10)
    path = str(tmp_path / "ck")
    tcore.run_pigeon(module, data, pcfg, engine="batched", device="cpu",
                     checkpoint_path=path, checkpoint_every=3)
    assert written == [2, 3]                   # (t+1) % 3 == 0, and the last round
    written.clear()
    tcore.run_pigeon(module, data, pcfg, engine="sequential", device="cpu",
                     checkpoint_path=path)
    assert written == [0, 1, 2, 3]


def test_resume_recovers_from_torn_checkpoint(port, tmp_path):
    data, module, pcfg = port
    path = str(tmp_path / "ck")
    kw = dict(engine="batched", device="cpu", **LF)
    tcore.run_pigeon(module, data, pcfg, checkpoint_path=path, **kw)
    with open(path + ".npz", "r+b") as f:
        f.truncate(16)
    h_fresh = tcore.run_pigeon(module, data, pcfg, **kw)
    with pytest.warns(UserWarning, match="corrupt checkpoint"):
        h_res = tcore.run_pigeon(module, data, pcfg, checkpoint_path=path, resume=True,
                                 **kw)
    assert_tail_bit_identical(h_fresh, h_res, start=0)


def test_resume_missing_checkpoint_starts_fresh(port, tmp_path):
    data, module, pcfg = port
    h = tcore.run_pigeon(module, data, pcfg, engine="batched", device="cpu",
                         checkpoint_path=str(tmp_path / "never_saved"), resume=True, **LF)
    assert [r["round"] for r in h.rounds] == list(range(pcfg.T))


def test_resume_past_final_round_returns_restored_state(port, tmp_path):
    import warnings
    data, module, pcfg = port
    path = str(tmp_path / "done")
    h_full = tcore.run_pigeon(module, data, pcfg, checkpoint_path=path, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        h_res = tcore.run_pigeon(module, data, pcfg, checkpoint_path=path, resume=True,
                                 device="cpu")
    assert any("nothing left to train" in str(w.message) for w in caught)
    assert len(h_res.rounds) == 1
    rec = h_res.rounds[0]
    assert rec["resumed_terminal"] is True and rec["round"] == pcfg.T - 1
    assert rec["test_acc"] == h_full.rounds[-1]["test_acc"]


# ---------------------------------------------------------------------------
# the checkpoint files and the stream snapshots
# ---------------------------------------------------------------------------

def test_save_and_restore_modules_round_trip(tmp_path):
    a, b = _tiny_modules(0), _tiny_modules(1)
    path = str(tmp_path / "ck")
    save_checkpoint(path, a, {"round": 3})
    arrays, meta = load_checkpoint(path)
    assert meta == {"round": 3}
    assert sorted(arrays) == ["0/0.bias", "0/0.weight", "0/2.bias", "0/2.weight",
                              "1/bias", "1/weight"]
    assert restore_pytree(path, b) is b
    for m, n in zip(a, b):
        for p, q in zip(m.parameters(), n.parameters()):
            assert torch.equal(p, q)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(path, (nn.Sequential(nn.Linear(3, 5), nn.ReLU(), nn.Linear(5, 2)),
                              nn.Linear(2, 5)))
    with pytest.raises(KeyError):
        restore_pytree(path, (nn.Linear(3, 4), nn.Linear(2, 5)))


def test_protocol_state_metadata_roundtrips_through_json():
    rng = np.random.default_rng(0)
    seed_gen = torch.Generator().manual_seed(1)
    param_gen = torch.Generator().manual_seed(2)
    rng.integers(0, 100, size=17)                    # advance the streams
    torch.randint(0, 10, (5,), generator=seed_gen)
    torch.randn(7, generator=param_gen)
    meta = json.loads(json.dumps(protocol_state_metadata(rng, seed_gen, param_gen)))
    assert meta["param_gen_device"] == "cpu"
    rng2, s2, p2 = (np.random.default_rng(9), torch.Generator().manual_seed(9),
                    torch.Generator().manual_seed(9))
    restore_protocol_state(rng2, s2, p2, meta)
    np.testing.assert_array_equal(rng2.integers(0, 100, size=8), rng.integers(0, 100, size=8))
    assert torch.equal(torch.randint(0, 1 << 30, (4,), generator=s2),
                       torch.randint(0, 1 << 30, (4,), generator=seed_gen))
    assert torch.equal(torch.randn(4, generator=p2), torch.randn(4, generator=param_gen))


def test_resume_on_another_device_type_raises():
    rng, gen = np.random.default_rng(0), torch.Generator()
    meta = protocol_state_metadata(rng, gen, gen)
    meta["param_gen_device"] = "cuda"
    with pytest.raises(ValueError, match="device type"):
        restore_protocol_state(rng, gen, gen, meta)


def test_save_checkpoint_atomic_leaves_no_temp_residue(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tiny_modules(), {"round": 0})
    save_checkpoint(path, _tiny_modules(1), {"round": 1})
    assert sorted(os.listdir(tmp_path)) == ["ck.json", "ck.npz"]
    assert load_checkpoint(path)[1]["round"] == 1


def test_torn_checkpoint_token_mismatch_detected(tmp_path):
    """The arrays of one save beside the manifest of another."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    save_checkpoint(a, _tiny_modules(), {"round": 0})
    save_checkpoint(b, _tiny_modules(), {"round": 1})
    os.replace(b + ".json", a + ".json")
    with pytest.raises(CorruptCheckpointError, match="torn"):
        load_checkpoint(a)


def test_truncated_arrays_and_unparseable_manifest_detected(tmp_path):
    path = str(tmp_path / "ck")
    save_checkpoint(path, _tiny_modules(), {"round": 0})
    with open(path + ".npz", "r+b") as f:
        f.truncate(16)
    with pytest.raises(CorruptCheckpointError, match="arrays"):
        load_checkpoint(path)
    save_checkpoint(path, _tiny_modules(), {"round": 0})
    with open(path + ".json", "w") as f:
        f.write('{"names": [')
    with pytest.raises(CorruptCheckpointError, match="manifest"):
        load_checkpoint(path)


def test_reference_and_port_share_the_token_contract(tmp_path):
    """A checkpoint half written by one package and the other half by the
    other is torn on both readers; each reads its own whole save."""
    import jax.numpy as jnp
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(jpath, {"w": jnp.ones((2, 3))}, {"round": 1})
    save_checkpoint(tpath, _tiny_modules(), {"round": 1})
    assert jckpt.load_checkpoint(jpath)[1] == load_checkpoint(tpath)[1] == {"round": 1}
    os.replace(jpath + ".json", tpath + ".json")
    for load in (load_checkpoint, jckpt.load_checkpoint):
        with pytest.raises((CorruptCheckpointError, jckpt.CorruptCheckpointError)):
            load(tpath)
