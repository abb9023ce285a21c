"""The Pigeon-SL round over a MoE: ``run_pigeon`` over ``from_lm`` of a tiny
DeepSeek-V2-Lite (MLA, one dense layer, two MoE layers with a shared
expert; cut 2, so each half holds a MoE layer) on both of the port's
engines against the reference's batched runs: honest, label flip, and int8
under ``loss_plus_distance``.  ``selected``, ``detections``, ``accepted``
and ``comm`` equal the reference's, validation losses within rtol 1e-4
(f32).  The batched engine trains the cluster-stacked MoE (a call a slot),
whose routing and dropping a slot are its plain model's; the sequential
engine the plain model.  Also the entry points on the CPU: ``serve`` and
``train --engine batched`` over the smoke configs."""
import copy
import dataclasses

import jax
import numpy as np
import pytest

import repro.core as jcore
from repro.data import build_lm_task as jax_build_lm_task
from repro.models import build_model as jax_build_model
import repro_torch.core as tcore
from repro_torch.convert import lm_split_from_reference
from repro_torch.data import build_lm_task
from repro_torch.kernels import build as tbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import ModelConfig, build_model
from _torch_threads import one_thread  # noqa: F401

ROUND_RTOL = 1e-4
ARCHS = ["deepseek-v2-lite-16b", "qwen3-moe-30b-a3b"]


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


TINY = dict(name="tiny-mla-moe", arch_type="moe", n_layers=3, d_model=32, n_heads=2,
            n_kv_heads=2, head_dim=16, d_ff=64, vocab=64, kv_lora_rank=16, rope_dim=8,
            n_experts=4, top_k=2, d_expert=16, n_shared_experts=1, first_dense=1,
            cut_layer=2)
TINY_TASK = dict(vocab=64, seq_len=16, m_clients=2, d_m=32, d_o=16, n_test=16, seed=0)
TINY_PCFG = dict(M=2, N=1, T=2, E=2, B=8, lr=5e-2, seed=0)
DISCRETE = ("clusters", "selected", "accepted", "detections", "selected_honest", "comm")
ROUND_CASES = {"honest": dict(),
               "label_flip": dict(malicious={1}, attack=jcore.LABEL_FLIP),
               "stats_int8": dict(malicious={1}, attack=jcore.LABEL_FLIP,
                                  selection="loss_plus_distance", quant="int8")}


@pytest.fixture(scope="module")
def moe_round():
    from repro.models.config import ModelConfig as JModelConfig
    jmodule = jcore.from_lm(jax_build_model(JModelConfig(**TINY)))
    pcfg = jcore.ProtocolConfig(**TINY_PCFG)
    _, k0 = jax.random.split(jax.random.PRNGKey(pcfg.seed))     # run_pigeon's init key
    jg, jp = jmodule.init(k0)
    theta = lm_split_from_reference(ModelConfig(**TINY), _np_tree(jg), _np_tree(jp))
    tmodule = dataclasses.replace(tcore.from_lm(build_model(ModelConfig(**TINY), "cpu")),
                                  init=lambda _g: copy.deepcopy(theta))
    return dict(jmodule=jmodule, jdata=jax_build_lm_task(**TINY_TASK), jpcfg=pcfg,
                tmodule=tmodule, data=build_lm_task(**TINY_TASK),
                pcfg=tcore.ProtocolConfig(**TINY_PCFG))


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_run_pigeon_over_a_tiny_deepseek_matches_reference(case, moe_round):
    kw = dict(ROUND_CASES[case])
    kind = kw.pop("attack", jcore.NONE)
    want = jcore.run_pigeon(moe_round["jmodule"], moe_round["jdata"], moe_round["jpcfg"],
                            attack=jcore.Attack(kind), engine="batched", **kw)
    for engine in ("batched", "sequential"):
        got = tcore.run_pigeon(moe_round["tmodule"], moe_round["data"], moe_round["pcfg"],
                               attack=tcore.Attack(kind), engine=engine, device="cpu", **kw)
        assert len(got.rounds) == len(want.rounds)
        for rg, rw in zip(got.rounds, want.rounds):
            for k in DISCRETE:
                assert rg[k] == rw[k], (case, engine, rw["round"], k)
            np.testing.assert_allclose(rg["val_losses"], rw["val_losses"], rtol=ROUND_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_run_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--device", "cpu", "--batch", "1", "--prompt-len", "4",
                 "--new-tokens", "2"])
    assert f"arch={arch}-smoke" in capsys.readouterr().out


def test_train_cli_runs_a_moe_on_the_cpu(capsys):
    ttrain.main(["--arch", "deepseek-v2-lite-16b", "--device", "cpu", "--protocol", "pigeon",
                 "--engine", "batched", "--rounds", "1", "--local-steps", "1", "--clients",
                 "2", "--batch", "2"])
    assert "done: pigeon rounds=1" in capsys.readouterr().out
