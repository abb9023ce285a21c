"""The batched engine over an LM: ``run_pigeon``/``run_splitfed(engine=
"batched")`` over ``from_lm`` (the cluster-stacked LM, ``from_lm(model).
stacked``) against the reference's batched runs and the port's own
sequential engine.

The fixture is ``tests/test_torch_train.py``'s tiny LM (2 layers, d_model
64, the reference's initial (gamma, phi) carried across).  Tolerances, f32
throughout: the rounds' discrete outcomes equal the reference's and their
losses and test accuracy within rtol 1e-4; the port's batched and
sequential engines take equal decisions and their validation losses agree
within the same rtol.  The stacked LM itself, slot by slot, is
``tests/test_torch_lm_steps.py``'s."""
import copy
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as jcore
from repro.data import build_lm_task as jax_build_lm_task
from repro.models import build_model as jax_build_model
from repro.models.config import ModelConfig as JModelConfig
import repro_torch.core as tcore
from repro_torch.convert import lm_split_from_reference
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.models import ModelConfig, build_model
from _torch_threads import one_thread  # noqa: F401

ROUND_RTOL = 1e-4
TINY = dict(name="tiny-lm", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab=64, cut_layer=1)
TINY_TASK = dict(vocab=64, seq_len=32, m_clients=2, d_m=64, d_o=32, n_test=32, seed=0)
TINY_PCFG = dict(M=2, N=1, T=2, E=3, B=8, lr=5e-2, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest",
            "honest_cluster_exists", "comm")
FLOATS = ("val_losses", "train_losses", "test_acc")


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the batched engine over from_lm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_round():
    """The reference's task and split module for the fixture, the port's
    module carrying the reference's initial (gamma, phi), and a cache of
    the reference's batched runs (one run a case for the module)."""
    cfg = JModelConfig(**TINY)
    jmodule = jcore.from_lm(jax_build_model(cfg))
    jdata = jax_build_lm_task(**TINY_TASK)
    pcfg = jcore.ProtocolConfig(**TINY_PCFG)
    _, k0 = jax.random.split(jax.random.PRNGKey(pcfg.seed))   # run_pigeon's init key
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(ModelConfig(**TINY), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(ModelConfig(**TINY), "cpu")),
                                  init=lambda _g: copy.deepcopy(theta))
    return dict(jmodule=jmodule, jdata=jdata, jpcfg=pcfg, tmodule=tmodule,
                data=build_lm_task(**TINY_TASK), pcfg=tcore.ProtocolConfig(**TINY_PCFG),
                ref={})


def _reference(lm_round, driver: str, case: str, kw):
    if case not in lm_round["ref"]:
        kw = dict(kw)
        kind = kw.pop("attack", jcore.NONE)
        pcfg = dataclasses.replace(lm_round["jpcfg"], **kw.pop("pcfg", {}))
        run = getattr(jcore, driver)
        if driver == "run_splitfed":
            lm_round["ref"][case] = run(lm_round["jmodule"], lm_round["jdata"], pcfg, {1},
                                        jcore.Attack(kind), engine="batched", **kw)
        else:
            lm_round["ref"][case] = run(lm_round["jmodule"], lm_round["jdata"], pcfg,
                                        attack=jcore.Attack(kind), engine="batched", **kw)
    return lm_round["ref"][case]


def _port(lm_round, driver: str, kw, engine: str = "batched"):
    kw = dict(kw)
    kind = kw.pop("attack", jcore.NONE)
    pcfg = dataclasses.replace(lm_round["pcfg"], **kw.pop("pcfg", {}))
    run = getattr(tcore, driver)
    if driver == "run_splitfed":
        return run(lm_round["tmodule"], lm_round["data"], pcfg, {1}, tcore.Attack(kind),
                   engine=engine, device="cpu", **kw)
    return run(lm_round["tmodule"], lm_round["data"], pcfg, attack=tcore.Attack(kind),
               engine=engine, device="cpu", **kw)


def _assert_matches(got, want, what, floats=True):
    assert len(got.rounds) == len(want.rounds)
    for rg, rw in zip(got.rounds, want.rounds):
        for k in DISCRETE:
            if k in rw:
                assert rg[k] == rw[k], (what, rw["round"], k)
        for k in FLOATS:
            if floats and k in rw:
                np.testing.assert_allclose(rg[k], rw[k], rtol=ROUND_RTOL, atol=0,
                                           err_msg=f"{what} round {rw['round']} {k}")


# "stats_int8": the int8 wire under a policy that scores the transmitted
# messages' statistics (B3 on every client step's uplink)
ROUND_CASES = {"honest": dict(),
               "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
               "stats_int8": dict(malicious={1}, attack=jcore.LABEL_FLIP,
                                  selection="loss_plus_distance", quant="int8"),
               "plus": dict(malicious={1}, attack=jcore.LABEL_FLIP, plus=True),
               # T = 3 with eval_every 3: rounds 1 and 2 fuse into one block;
               # held against the reference's per-round run (its block run
               # gives the same History)
               "block2": dict(malicious={1}, attack=jcore.LABEL_FLIP, block=2,
                              pcfg=dict(T=3, eval_every=3))}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_batched_run_pigeon_over_from_lm_matches_reference(case, lm_round):
    kw = ROUND_CASES[case]
    ref_kw = {k: v for k, v in kw.items() if k != "block"}
    want = _reference(lm_round, "run_pigeon", case, ref_kw)
    _assert_matches(_port(lm_round, "run_pigeon", kw), want, case)


@pytest.mark.parametrize("case", ["label_flip", "stats_int8", "plus"])
def test_batched_run_pigeon_over_from_lm_decides_as_sequential(case, lm_round):
    """The port's two engines over the LM: the same decisions (and, on the
    CPU, the same floats)."""
    kw = ROUND_CASES[case]
    seq = _port(lm_round, "run_pigeon", kw, engine="sequential")
    batched = _port(lm_round, "run_pigeon", kw)
    _assert_matches(batched, seq, case, floats=False)
    for rb, rs in zip(batched.rounds, seq.rounds):
        np.testing.assert_allclose(rb["val_losses"], rs["val_losses"], rtol=ROUND_RTOL)


def test_batched_run_splitfed_over_from_lm_matches_reference(lm_round):
    kw = dict(attack=jcore.LABEL_FLIP)
    want = _reference(lm_round, "run_splitfed", "splitfed", kw)
    _assert_matches(_port(lm_round, "run_splitfed", kw), want, "splitfed")
