"""Parity of the port's sequential Pigeon-SL round with the JAX reference on
the tiny fixtures (``conftest.tiny_task`` / ``tiny_pcfg``): the same task
arrays, the same cluster lists and batches, and — from the converted JAX
init — the same discrete outcomes every round.

Floats: ``val_losses`` / ``train_losses`` / ``test_acc`` agree at rtol 1e-4
on f32 runs and 1e-3 on quantized runs, where a tiny float drift can move
one element across a rounding boundary of the quantizer."""
import dataclasses
import os

import jax
import numpy as np
import pytest

import jax.numpy as jnp
import torch

import repro.core as jcore
import repro.selection as jsel
from repro.core.clustering import make_clusters as jax_make_clusters
import repro_torch.core as tcore
import repro_torch.selection as tsel
from repro_torch.convert import from_reference
from repro_torch.core.clustering import make_clusters as torch_make_clusters
from repro_torch.data import build_image_task as torch_build_image_task
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")


@pytest.fixture(scope="module")
def port(tiny_task, tiny_pcfg):
    """The port's task, its module carrying the reference's initial
    parameters for ``tiny_pcfg.seed``, and its ProtocolConfig."""
    jdata, jmod = tiny_task
    data, cfg = torch_build_image_task("mnist", **TASK)
    key = jax.random.PRNGKey(tiny_pcfg.seed)
    _, k0 = jax.random.split(key)                 # run_pigeon's init key
    jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
    theta = from_reference(cfg, jg, jp)
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: theta)
    fields = {f.name: getattr(tiny_pcfg, f.name)
              for f in dataclasses.fields(tcore.ProtocolConfig)}
    fields["comm"] = tcore.CommConfig(tiny_pcfg.comm.quant)
    return data, module, tcore.ProtocolConfig(**fields)


def test_task_arrays_bit_equal(tiny_task):
    jdata, _ = tiny_task
    data, cfg = torch_build_image_task("mnist", **TASK)
    assert cfg.name == "mnist_cnn"
    for name in ("x", "y", "x0", "y0", "x_test", "y_test"):
        a, b = getattr(data, name), getattr(jdata, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m,r", [(4, 2), (20, 5), (12, 4)])
def test_make_clusters_same_lists(m, r):
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(5):
        assert torch_make_clusters(rt, m, r) == jax_make_clusters(rj, m, r)


CASES = {
    "honest": dict(),
    "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
    "gradient": dict(malicious={1}, attack=jcore.GRADIENT),
    "param_tamper": dict(malicious={0, 1}, attack=jcore.PARAM_TAMPER),
    "param_tamper_last": dict(malicious={2, 3}, attack=jcore.PARAM_TAMPER),
    "int8_loss_plus_distance": dict(quant="int8", selection="loss_plus_distance"),
    "fp8_argmin": dict(quant="fp8_e4m3"),
    "plus": dict(plus=True),
    "trimmed": dict(malicious={1}, attack=jcore.LABEL_FLIP, selection="trimmed"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_pigeon_matches_reference(case, tiny_task, tiny_pcfg, port):
    jdata, jmod = tiny_task
    data, module, pcfg = port
    kw = dict(CASES[case])
    kind = kw.pop("attack", jcore.NONE)
    hj = jcore.run_pigeon(jmod, jdata, tiny_pcfg, attack=jcore.Attack(kind),
                          engine="sequential", **kw)
    ht = tcore.run_pigeon(module, data, pcfg, attack=tcore.Attack(kind),
                          device="cpu", **kw)
    rtol = 1e-3 if kw.get("quant") else 1e-4
    assert len(hj.rounds) == len(ht.rounds) == tiny_pcfg.T
    for rj, rt in zip(hj.rounds, ht.rounds):
        for k in DISCRETE:
            assert rt[k] == rj[k], (case, rj["round"], k)
        for k in ("val_losses", "train_losses", "test_acc"):
            np.testing.assert_allclose(rt[k], rj[k], rtol=rtol, atol=0,
                                       err_msg=f"{case} round {rj['round']} {k}")
    if case == "param_tamper_last":
        assert sum(r["detections"] for r in ht.rounds) > 0


@pytest.mark.parametrize("seed", range(4))
def test_policies_score_and_rank_like_reference(seed):
    """Scores, eligibility and visit order of every ported policy on the same
    features, ties included (the sort-based median, not torch.median)."""
    rng = np.random.default_rng(seed)
    vl = rng.normal(2.3, 0.05, size=5).astype(np.float32)
    vl[seed % 5] = vl[(seed + 1) % 5]                 # a tie
    if seed == 3:
        vl[0] = 9.0                                   # a trimmed outlier
    st = np.abs(rng.normal(1.0, 0.3, size=(5, 4, 2))).astype(np.float32)
    st[seed % 5, 0, 1] += 3.0                         # one anomalous client
    for name in ("argmin", "trimmed", "loss_plus_distance"):
        jp_, tp_ = jsel.resolve_policy(name), tsel.resolve_policy(name)
        jctx = jsel.ScoreContext(vlosses=jnp.asarray(vl), message_stats=jnp.asarray(st))
        tctx = tsel.ScoreContext(vlosses=torch.from_numpy(vl),
                                 message_stats=torch.from_numpy(st))
        js, je, jo = jsel.score_and_rank(jp_, jctx)
        ts, te, to = tsel.score_and_rank(tp_, tctx)
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(to, jo)
    for axis in (None, 1):
        x = st[..., 0]
        np.testing.assert_array_equal(
            tsel.robust_z(torch.from_numpy(x), dim=axis).numpy(),
            np.asarray(jsel.robust_z(jnp.asarray(x), axis=axis)))


def test_unported_paths_raise(port, tmp_path):
    """The sharded placement still raises, for ``run_pigeon`` and the
    sweep; prefetch, block, checkpointing and telemetry run and leave the
    History as it was."""
    data, module, pcfg = port
    with pytest.raises(NotImplementedError):
        tcore.run_pigeon(module, data, pcfg, device="cpu", engine="batched",
                         placement="sharded")
    with pytest.raises(NotImplementedError):
        tcore.run_pigeon_sweep(module, data, pcfg, placement="sharded", device="cpu")
    from repro_torch.telemetry import MemorySink
    plain = tcore.run_pigeon(module, data, pcfg, device="cpu", engine="batched")
    for kw in (dict(prefetch=1), dict(block=2), dict(checkpoint_path=str(tmp_path / "ckpt")),
               dict(telemetry=tcore.Telemetry(sinks=(MemorySink(),)))):
        assert tcore.run_pigeon(module, data, pcfg, device="cpu", engine="batched",
                                **kw).rounds == plain.rounds, kw
    assert os.path.exists(tmp_path / "ckpt.npz")


#: names of the reference's package surfaces the port does not carry: the
#: mesh placements (no single-card counterpart), the compile cache (none:
#: PyTorch runs eagerly), the jitted round and the vmapped client update (the
#: stacked model writes the cluster axis out instead)
NOT_YET_PORTED = {
    "core": {"batched_round", "client_update_vec", "cluster_mesh", "sweep_mesh",
             "check_partial_auto_backend", "enable_compile_cache", "compile_cache_stats"},
    "core.attacks": set(),
    "selection": set(),
    "data": set(),
    "telemetry": set(),
    "checkpoint": set(),
}


@pytest.mark.parametrize("pkg", sorted(NOT_YET_PORTED))
def test_import_surface_matches_reference(pkg):
    """Every name of the reference's ``__all__`` imports from the same
    module path in the port, except the named ones still to come."""
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    missing = {n for n in ref.__all__ if not hasattr(port, n)}
    assert missing == NOT_YET_PORTED[pkg]
    assert set(ref.__all__) - missing <= set(port.__all__)


def test_threat_model_imports_from_core():
    from repro_torch.core import ClientThreat, ThreatModel, every_k
    from repro_torch.core.attacks import attack_vec_for_clusters
    tm = ThreatModel.build({1: ClientThreat(tcore.Attack(tcore.LABEL_FLIP), every_k(2))})
    assert tm.malicious == {1}
    av = attack_vec_for_clusters(tcore.Attack(tcore.LABEL_FLIP), [[0, 1], [2, 3]], {1})
    assert av.host_code.tolist() == [[0, 1], [0, 0]]
