"""The port's examples (``examples_torch/``), each the counterpart of the
reference's example of the same name in ``examples/``: each runs its
``main`` on the CPU (``--device cpu``), imports neither ``jax`` nor
``repro``, and asks for the card by default.  The quickstart's Pigeon-SL+
decisions (clusters, selection, acceptance, detections, honesty, wire
bytes) equal the reference's ``run_pigeon`` at ``examples/quickstart.py``'s
settings exactly: its gradient attack is a sign flip, no noise.  The
robust LM example runs at 2 rounds of 2 steps a client (its defaults are 4
and 4)."""
import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.data import build_image_task as jax_build_image_task
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import build as tbuild
from _torch_threads import one_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"
NAMES = ("attack_sweep", "quickstart", "robust_llm_training", "serve_decode")
DECISIONS = ("clusters", "selected", "accepted", "detections", "selected_honest",
             "honest_cluster_exists", "comm")


def _example(name: str):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _no_kernel_on_cpu(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path tried to build or load a kernel")

    monkeypatch.setattr(tbuild, "load", refuse)
    monkeypatch.setattr(tbuild, "_start", refuse)


def test_every_reference_example_has_its_counterpart():
    ref = {p.stem for p in (EXAMPLES.parent / "examples").glob("*.py")}
    assert ref == {p.stem for p in EXAMPLES.glob("*.py")} == set(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_examples_import_neither_jax_nor_the_reference(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("name", NAMES)
def test_examples_ask_for_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        _example(name).main([])


def test_quickstart_decides_as_the_reference(capsys):
    hist_p, hist_v = _example("quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "final accuracy: pigeon+=" in out and "honest cluster 6/6 rounds" in out
    data, cnn_cfg = jax_build_image_task("mnist", m_clients=4, d_m=300, d_o=150,
                                         n_test=1000, seed=0)
    pcfg = jcore.ProtocolConfig(M=4, N=1, T=6, E=5, B=32, lr=0.05, seed=0)
    ref = jcore.run_pigeon(jcore.from_cnn(cnn_cfg), data, pcfg, {1},
                           jcore.Attack(jcore.GRADIENT), plus=True)
    assert len(hist_p.rounds) == len(ref.rounds) == len(hist_v.rounds) == 6
    for rp, rr in zip(hist_p.rounds, ref.rounds):
        for k in DECISIONS:
            assert rp[k] == rr[k], (rr["round"], k)
    assert all(np.isfinite(r["train_loss"]) for r in hist_v.rounds)


def test_attack_sweep_prints_its_matrix(capsys):
    out = _example("attack_sweep").main(["--device", "cpu"])
    assert list(out) == ["label_flip", "activation", "gradient", "mixed"]
    assert all(0.0 <= a <= 1.0 for accs in out.values() for a in accs)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].split() == ["threat", "vanilla", "pigeon", "pigeon+"]
    assert [line.split()[0] for line in printed[1:]] == list(out)


def test_robust_llm_training_runs(capsys):
    hist = _example("robust_llm_training").main(["--device", "cpu", "--rounds", "2",
                                                 "--steps-per-client", "2"])
    out = capsys.readouterr().out
    assert "cut at block 1" in out and "final next-token accuracy" in out
    assert len(hist.rounds) == 2 and all(r["accepted"] for r in hist.rounds)
    assert all(np.all(np.isfinite(r["val_losses"])) for r in hist.rounds)


def test_serve_decode_decodes_the_three_families(capsys):
    out = _example("serve_decode").main(["--device", "cpu"])
    assert list(out) == ["qwen3-8b", "zamba2-1.2b", "deepseek-v2-lite-16b"]
    for arch, gen in out.items():
        assert gen.shape == (4, 20)
        assert gen.min() >= 0 and gen.max() < get_smoke_config(arch).vocab
    assert capsys.readouterr().out.startswith("device: CPU")
