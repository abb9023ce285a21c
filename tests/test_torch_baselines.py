"""Parity of the port's baselines, vanilla SL and clustered SplitFed, with
the JAX reference on the tiny fixtures (``conftest.tiny_task`` /
``tiny_pcfg``) from the converted JAX init, and of the port's two SplitFed
engines with each other.

Discrete fields (``selected``, ``selected_honest``, the ``comm`` dicts) must
be equal.  Floats (validation and training losses, test accuracy) agree at
rtol 1e-4 on f32 runs and 1e-3 on quantized runs, where a tiny float drift
can move one element across a rounding boundary of the quantizer; the
port's two engines differ only in summation order (grouped convolutions,
batched products, the FedAvg mean over a stacked axis), so they share those
tolerances.  The stochastic attack families draw their noise from the
port's per-turn torch seeds, so they are held between the port's engines
only, not against JAX.  The data helpers and ``select_cluster`` are held
to the reference's bits."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.protocol import account_splitfed_round as jax_account_splitfed_round
from repro.core.validation import select_cluster as jax_select_cluster
from repro.data.pipeline import dirichlet_relabel as jax_dirichlet_relabel
from repro.data.pipeline import minibatches as jax_minibatches
import repro_torch.core as tcore
from repro_torch.convert import from_reference
from repro_torch.core.protocol import account_splitfed_round
from repro_torch.core.validation import select_cluster
from repro_torch.data import build_image_task as torch_build_image_task
from repro_torch.data import dirichlet_relabel, minibatches
from repro_torch.models.cnn import MNIST_CNN
from _torch_threads import one_thread  # noqa: F401

TASK = dict(m_clients=4, d_m=120, d_o=60, n_test=200, seed=0)
SFL_DISCRETE = ("selected", "selected_honest", "comm")
SFL_FLOATS = ("val_losses", "test_acc")

VANILLA_CASES = {
    "honest": dict(),
    "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
    "int8": dict(quant="int8"),
}
SFL_CASES = {
    "honest": dict(),
    "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
    "int8": dict(quant="int8"),
    "int8_loss_plus_distance": dict(quant="int8", selection="loss_plus_distance"),
}
# the port's engines against each other: the reference's cases, the
# stochastic families (one noise seed a client on both engines), and the
# host-selected batched path
ENGINE_CASES = dict(SFL_CASES,
                    activation=dict(malicious={1}, attack=jcore.ACTIVATION),
                    grad_noise_median_of_means=dict(malicious={0}, attack=jcore.GRAD_NOISE,
                                                    selection="median_of_means"))


def _rtol(kw):
    return 1e-3 if kw.get("quant") else 1e-4


def _kwargs(cases, case, pkg):
    kw = dict(cases[case])
    kw["attack"] = pkg.Attack(kw.pop("attack", pkg.NONE))
    return kw


@pytest.fixture(scope="module")
def port(tiny_task, tiny_pcfg):
    """The port's task, its module carrying the reference's initial
    parameters for ``tiny_pcfg.seed``, and its ProtocolConfig."""
    jdata, jmod = tiny_task
    data, cfg = torch_build_image_task("mnist", **TASK)
    _, k0 = jax.random.split(jax.random.PRNGKey(tiny_pcfg.seed))   # the drivers' init key
    jg, jp = jax.tree.map(np.asarray, jmod.init(k0))
    theta = from_reference(cfg, jg, jp)
    module = dataclasses.replace(tcore.from_cnn(cfg), init=lambda g: theta)
    fields = {f.name: getattr(tiny_pcfg, f.name)
              for f in dataclasses.fields(tcore.ProtocolConfig)}
    fields["comm"] = tcore.CommConfig(tiny_pcfg.comm.quant)
    return data, module, tcore.ProtocolConfig(**fields)


@pytest.fixture(scope="module")
def splitfed(tiny_task, tiny_pcfg, port):
    """Memoised SplitFed runs: (package, engine, case) -> History; engine
    "host" is the batched engine with host selection."""
    cache = {}

    def get(pkg, engine, case):
        if (pkg, engine, case) not in cache:
            eng = dict(engine="batched", _force_host_selection=True) if engine == "host" \
                else dict(engine=engine)
            if pkg == "jax":
                jdata, jmod = tiny_task
                cache[pkg, engine, case] = jcore.run_splitfed(
                    jmod, jdata, tiny_pcfg, **eng, **_kwargs(SFL_CASES, case, jcore))
            else:
                data, module, pcfg = port
                cache[pkg, engine, case] = tcore.run_splitfed(
                    module, data, pcfg, device="cpu", **eng,
                    **_kwargs(ENGINE_CASES, case, tcore))
        return cache[pkg, engine, case]

    return get


def _assert_same_rounds(ha, hb, discrete, floats, label, rtol):
    assert len(ha.rounds) == len(hb.rounds)
    for ra, rb in zip(ha.rounds, hb.rounds):
        assert sorted(ra) == sorted(rb), label
        for k in discrete:
            assert ra[k] == rb[k], (label, ra["round"], k)
        for k in floats:
            np.testing.assert_allclose(ra[k], rb[k], rtol=rtol, atol=0,
                                       err_msg=f"{label} round {ra['round']} {k}")


@pytest.mark.parametrize("case", sorted(VANILLA_CASES))
def test_run_vanilla_sl_matches_reference(case, tiny_task, tiny_pcfg, port):
    jdata, jmod = tiny_task
    data, module, pcfg = port
    hj = jcore.run_vanilla_sl(jmod, jdata, tiny_pcfg, **_kwargs(VANILLA_CASES, case, jcore))
    ht = tcore.run_vanilla_sl(module, data, pcfg, device="cpu",
                              **_kwargs(VANILLA_CASES, case, tcore))
    assert len(ht.rounds) == tiny_pcfg.T
    _assert_same_rounds(ht, hj, ("round", "comm"), ("train_loss", "test_acc"), case,
                        _rtol(VANILLA_CASES[case]))


@pytest.mark.parametrize("engine", ["sequential", "batched"])
@pytest.mark.parametrize("case", sorted(SFL_CASES))
def test_run_splitfed_matches_reference(case, engine, tiny_pcfg, splitfed):
    ht = splitfed("torch", engine, case)
    assert len(ht.rounds) == tiny_pcfg.T
    _assert_same_rounds(ht, splitfed("jax", engine, case), SFL_DISCRETE, SFL_FLOATS,
                        f"{case} {engine}", _rtol(SFL_CASES[case]))


@pytest.mark.parametrize("engine", ["batched", "host"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_splitfed_engines_agree(case, engine, splitfed):
    _assert_same_rounds(splitfed("torch", engine, case),
                        splitfed("torch", "sequential", case), SFL_DISCRETE, SFL_FLOATS,
                        f"{case} {engine}", _rtol(ENGINE_CASES[case]))


def test_splitfed_batched_wire_shapes(port, monkeypatch):
    """The batched round sends every client's message at once: B2 takes
    (R * M_bar * B, d_c) rows, B3 (R * M_bar, B, d_c) messages, once a
    step in each direction (B3 replacing the uplink's B2 under
    loss_plus_distance)."""
    from repro_torch.kernels import ops as tops
    data, module, pcfg = port
    seen = []
    real = (tops.quant_roundtrip, tops.quant_roundtrip_stats)

    def spy(i):
        def call(x, fmt):
            seen.append((i, tuple(x.shape)))
            return real[i](x, fmt)
        return call

    monkeypatch.setattr(tops, "quant_roundtrip", spy(0))
    monkeypatch.setattr(tops, "quant_roundtrip_stats", spy(1))
    lanes, d_c = pcfg.M, MNIST_CNN.d_cut        # R * M_bar clients; the cut width
    for selection, uplink in (("argmin", (0, (lanes * pcfg.B, d_c))),
                              ("loss_plus_distance", (1, (lanes, pcfg.B, d_c)))):
        seen.clear()
        tcore.run_splitfed(module, data, pcfg, engine="batched", quant="int8",
                           selection=selection, device="cpu")
        assert seen == [uplink, (0, (lanes * pcfg.B, d_c))] * pcfg.E * pcfg.T, selection


def test_account_splitfed_round_matches_reference(tiny_pcfg, port):
    _, _, pcfg = port
    for quant in (None, "int8"):
        jm, tm = jcore.CommMeter(), tcore.CommMeter()
        clusters = [[0, 2], [3, 1]]
        jax_account_splitfed_round(
            jm, dataclasses.replace(tiny_pcfg, comm=jcore.CommConfig(quant)), clusters,
            60, 32, 1234)
        account_splitfed_round(tm, dataclasses.replace(pcfg, comm=tcore.CommConfig(quant)),
                               clusters, 60, 32, 1234)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)


@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_dirichlet_relabel_bit_equal(alpha, tiny_task):
    jdata, _ = tiny_task
    data, _ = torch_build_image_task("mnist", **TASK)
    a, b = dirichlet_relabel(data, alpha, seed=3), jax_dirichlet_relabel(jdata, alpha, seed=3)
    for name in ("x", "y", "x0", "y0", "x_test", "y_test"):
        assert getattr(a, name).dtype == getattr(b, name).dtype
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_minibatches_and_select_cluster_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 3, 4)).astype(np.float32)
    y = rng.integers(0, 10, size=50).astype(np.int32)
    got = list(minibatches(np.random.default_rng(5), x, y, 8, 6))
    want = list(jax_minibatches(np.random.default_rng(5), x, y, 8, 6))
    assert len(got) == len(want) == 6
    for (xa, ya), (xb, yb) in zip(got, want):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    for losses in ([2.3, 2.1, 2.1, 2.4], [float("nan"), 1.0], [5.0], np.float32([3, 1, 2])):
        assert select_cluster(losses) == jax_select_cluster(losses)


def test_baselines_refuse_what_is_not_ported(port, capsys):
    """SplitFed's sharded placement (a group of one here;
    ``tests/test_torch_sharded.py`` holds 2 to 4 ranks), prefetch, block,
    telemetry and verbose, and vanilla SL's telemetry and verbose, run and
    leave the History as it was."""
    from repro_torch.launch.mesh import group_of_one
    from repro_torch.telemetry import MemorySink, Telemetry
    data, module, pcfg = port
    plain = tcore.run_splitfed(module, data, pcfg, device="cpu", engine="batched")
    with group_of_one("gloo"):
        assert tcore.run_splitfed(module, data, pcfg, device="cpu", engine="batched",
                                  placement="sharded").rounds == plain.rounds
    for kw in (dict(prefetch=1), dict(block=2), dict(telemetry=Telemetry(sinks=(MemorySink(),))),
               dict(verbose=True)):
        assert tcore.run_splitfed(module, data, pcfg, device="cpu", engine="batched",
                                  **kw).rounds == plain.rounds, kw
    plain = tcore.run_vanilla_sl(module, data, pcfg, device="cpu")
    for kw in (dict(telemetry=Telemetry(sinks=(MemorySink(),))), dict(verbose=True)):
        assert tcore.run_vanilla_sl(module, data, pcfg, device="cpu", **kw).rounds == \
            plain.rounds, kw
    out = capsys.readouterr().out
    assert "[sfl] t=  0" in out and "[vanilla] t=  0" in out
    with pytest.raises(ValueError):
        tcore.run_splitfed(module, data, pcfg, engine="sequential", block=2, device="cpu")
    # the card by default: without one the drivers raise, never fall back
    if not torch.cuda.is_available():
        for driver in (tcore.run_vanilla_sl, tcore.run_splitfed):
            with pytest.raises(RuntimeError, match="CUDA"):
                driver(module, data, pcfg)
