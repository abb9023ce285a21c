"""The sharded placement of the port (``placement="sharded"``: the cluster
axis over the ranks of a ``torch.distributed`` group, ``launch/mesh.py``,
``core/runner.py``) against the reference's on the CPU.

The reference's runs come from one subprocess a session
(``tests/_sharded_oracle.py``) over an 8-device host mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``).  The port's come
from one gloo group a world size (2, 3 and 4 ranks, one intra-op thread a
rank, ``tests/_sharded_ranks.py``) that runs every case of that world; the
oracle runs after them.  The ranks and the oracle run at a lower scheduling
priority (``NICE``), so a timing-sensitive test on another worker keeps its
cores.  Each case is a test of its own, reading the session's results:

  * every rank returns rank 0's result;
  * the drivers' Histories equal the reference's sharded run: the discrete
    outcomes and ``comm`` exactly, the losses and test accuracy within rtol
    1e-4 (1e-3 with the int8 wire, where a tiny drift can move an element
    across a rounding boundary of the quantizer); world 3 leaves one rank
    outside a mesh of 2 (R = 4, the pool's 4 lanes, the sweep's 2 x 2
    grid);
  * ``block=2`` with ``prefetch=1`` equals block 1 bit for bit; the host
    cascade (param tamper, every candidate all-gathered) flags an attacker;
  * the shardmap round step of the smoke Qwen3-8B at world 2 gives the
    reference's ``sel`` and its losses within rtol 1e-5;
  * a losing cluster full of Inf on the other rank leaves the winner finite.
"""
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _sharded_cases as cases
import _sharded_ranks as ranks
from _torch_threads import one_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEADLINE_S = 240.0
#: the niceness the spawned ranks and the oracle run at
NICE = 10
WORLDS = {
    4: ("honest", "label_flip", "int8_loss_plus_distance", "param_tamper", "plus",
        "splitfed", "block1", "block2_prefetch1", "sweep", "pool", "meshes"),
    3: ("label_flip", "param_tamper", "splitfed", "sweep", "pool"),
    2: ("label_flip", "lm_step", "lm_step_block2", "inf_slot"),
}
DISCRETE = ("round", "clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")
FLOATS = ("val_losses", "train_losses", "test_acc")


def _lm_inputs():
    """The smoke LM's two reference inits and K rounds of batches."""
    from repro.configs import get_smoke_config
    from repro.models import build_model
    cfg = get_smoke_config(cases.LM["arch"])
    jm = build_model(cfg)
    trees = [jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(s)))
             for s in range(cases.LM["r"])]
    rng = np.random.default_rng(0)
    lm = cases.LM

    def batch(shape):
        return {n: rng.integers(0, cfg.vocab, shape).astype(np.int32)
                for n in ("tokens", "labels")}

    return dict(trees=trees, batches=batch((lm["k"], lm["r"], lm["b"], lm["s"])),
                val=batch((lm["d_o"], lm["s"])))


def _cnn_inits(jmod):
    """Each seed's reference initial parameters (run_pigeon's init key)."""
    out = {}
    for s in cases.SEEDS:
        _, k0 = jax.random.split(jax.random.PRNGKey(s))
        out[s] = jax.tree.map(np.asarray, jmod.init(k0))
    return out


@pytest.fixture(scope="session")
def sharded_runs(tmp_path_factory, tiny_task):
    """(reference, port {world: [rank results]}): the port's three groups
    one after another, then the oracle subprocess, so no more than one of
    them loads the CPU at a time."""
    from repro_torch.launch.mesh import spawn
    out_dir = tmp_path_factory.mktemp("sharded")
    inputs, result = str(out_dir / "inputs.pkl"), str(out_dir / "oracle.pkl")
    lm = _lm_inputs()
    inits = _cnn_inits(tiny_task[1])
    port = {w: spawn(ranks.run_world, w, "gloo", DEADLINE_S, args=(names, inits, lm, NICE),
                     threads=1)
            for w, names in WORLDS.items()}
    with open(inputs, "wb") as f:
        pickle.dump(dict(lm_trees=lm["trees"], lm_batches=lm["batches"], lm_val=lm["val"]), f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""),
               XLA_FLAGS=(flags + " --xla_force_host_platform_device_count=8").strip())
    oracle = subprocess.run(["nice", "-n", str(NICE), sys.executable,
                             os.path.join(HERE, "_sharded_oracle.py"), inputs, result],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, timeout=DEADLINE_S)
    assert oracle.returncode == 0, oracle.stdout
    with open(result, "rb") as f:
        return pickle.load(f), port


def assert_rounds_match(got, want, rtol, what):
    assert len(got) == len(want), what
    for rg, rw in zip(got, want):
        for k in DISCRETE:
            if k in rw:
                assert rg[k] == rw[k], (what, rw["round"], k)
        for k in FLOATS:
            assert (k in rg) == (k in rw), (what, k)
            if k in rw:
                np.testing.assert_allclose(rg[k], rw[k], rtol=rtol, atol=0,
                                           err_msg=f"{what} round {rw['round']} {k}")


def assert_case_matches(got, want, rtol, what):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for job in want:
            assert_rounds_match(got[job], want[job], rtol, f"{what} {job}")
    elif want and isinstance(want[0], list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_rounds_match(g, w, rtol, f"{what} seed {i}")
    else:
        assert_rounds_match(got, want, rtol, what)


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b, equal_nan=True)
    return a == b


DRIVER_CASES = [(w, n) for w, names in WORLDS.items() for n in names if n in cases.CASES]


@pytest.mark.parametrize("world,name", DRIVER_CASES)
def test_sharded_driver_matches_reference(sharded_runs, world, name):
    ref, port = sharded_runs
    results = [r[name] for r in port[world]]
    for rank, got in enumerate(results[1:], 1):
        assert _same(got, results[0]), f"rank {rank} differs from rank 0 in {name}"
    got = results[0]
    rtol = 1e-3 if cases.CASES[name][1].get("quant") else 1e-4
    if name in cases.BIT_EQUAL:
        assert _same(got, port[world][0][cases.BIT_EQUAL[name]]), name
        want = ref["runs"][cases.BIT_EQUAL[name]]
    else:
        want = ref["runs"][name]
    assert_case_matches(got, want, rtol, f"world {world} {name}")
    if name == "param_tamper":
        assert sum(r["detections"] for r in got) > 0


@pytest.mark.parametrize("block", [1, 2])
def test_shardmap_round_step_matches_reference(sharded_runs, block):
    """The smoke Qwen3-8B's round at world 2: ``sel`` exactly, the losses
    within rtol 1e-5, each rank's slot the reference's winner."""
    ref, port = sharded_runs
    name = "lm_step" if block == 1 else "lm_step_block2"
    want = ref["lm"][block]
    for rank, res in enumerate(port[2]):
        got = res[name]
        assert got["sel"].tolist() == want["sel"].tolist(), rank
        np.testing.assert_allclose(got["vlosses"], want["vlosses"], rtol=1e-5, atol=0)
        for a, b in zip(jax.tree.leaves(got["slot0"]), jax.tree.leaves(want["slot0"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_losing_inf_slot_leaves_the_winner_finite(sharded_runs):
    _, port = sharded_runs
    for res in port[2]:
        got = res["inf_slot"]
        assert got["sel"] == 0 and np.isinf(got["vlosses"][1])
        np.testing.assert_array_equal(got["w"], np.full((1, 3), 0.9, np.float32))


def test_meshes_match_reference(sharded_runs):
    """``cluster_mesh`` / ``sweep_mesh`` of a group of 4 for max_devices 1
    to 4, and the pure factorisation for 1 to 8, against the reference's
    meshes over 8 devices."""
    from repro_torch.core.runner import _largest_divisor, sweep_factors
    ref, port = sharded_runs
    for res in port[4]:
        got = res["meshes"]
        for key, shape in got["meshes"].items():
            assert shape == ref["meshes"][key], key
        for key, shape in got["sweep_meshes"].items():
            assert shape == ref["sweep_meshes"][key], key
    for (r, m), shape in ref["meshes"].items():
        assert {"pod": _largest_divisor(r, m)} == shape, (r, m)
    for (s, r, m), shape in ref["sweep_meshes"].items():
        assert dict(zip(("seed", "pod"), sweep_factors(s, r, m))) == shape, (s, r, m)


def test_indivisible_mesh_and_model_axes_raise():
    """An explicit mesh that does not divide R raises ``ValueError`` before
    any collective; a data or model axis > 1 (once refused) is taken as
    data and tensor parallelism: the runner and the shardmap step accept
    it, and the step refuses a model whose parallel view is not the mesh's;
    an axis neither manual nor data/model raises; the sharded placement
    needs a process group."""
    import repro_torch.core as tcore
    from repro_torch.core.runner import ClusterMesh, RoundRunner, protocol_round_spec
    from repro_torch.data import build_image_task
    from repro_torch.launch.steps import make_pigeon_round_step_shardmap
    data, cfg = build_image_task("mnist", **cases.TASK)
    spec = protocol_round_spec(tcore.from_cnn(cfg), cases.LR)
    seeds = np.zeros((4, 1), np.int64)
    runner = RoundRunner(spec, placement="sharded", mesh=ClusterMesh(("pod",), (3,), 0, 3))
    with pytest.raises(ValueError, match="R=4 not divisible by mesh axis 'pod'=3"):
        runner.accept(None, (None, None, None, seeds), None)
    with pytest.raises(ValueError, match=r"\(S=2, R=4\) not divisible"):
        RoundRunner(spec, placement="sharded", mesh=ClusterMesh(
            ("seed", "pod"), (1, 3), 0, 3)).sweep(None, (None, None, None,
                                                         np.zeros((2, 4, 1))), None)
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_stacked_model
    plain = build_stacked_model(get_smoke_config("qwen3-8b"), 1, device="cpu")
    for axes, dims in ((("pod", "data"), (1, 2)), (("pod", "model"), (2, 2))):
        mesh = ClusterMesh(axes, dims, 0, 4)
        assert tcore.check_partial_auto_backend(mesh, ("pod",)) == {axes[1]: 2}
        RoundRunner(spec, placement="sharded", mesh=mesh)
        with pytest.raises(ValueError, match="make_mesh"):
            mesh.pod_view()
        with pytest.raises(ValueError, match="not the model's"):
            make_pigeon_round_step_shardmap(plain, mesh)
    with pytest.raises(ValueError, match="neither the manual"):
        tcore.check_partial_auto_backend(ClusterMesh(("pod", "expert"), (2, 2), 0, 4),
                                         ("pod",))
    assert tcore.check_partial_auto_backend(
        ClusterMesh(("pod", "data"), (4, 1), 0, 4), ("pod",)) == {}
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tcore.cluster_mesh(4)


def test_hung_collective_fails_within_the_deadline():
    import time

    from repro_torch.launch.mesh import spawn
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        spawn(ranks.hang, 2, "gloo", deadline_s=8.0, threads=1)
    assert time.monotonic() - t0 < 30.0
