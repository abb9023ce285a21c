"""Quickstart: Pigeon-SL vs vanilla SL with one malicious client, on the
PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Trains the paper's MNIST CNN (synthetic class-template data) with M=4
clients, one of them gradient-tampering, and shows Pigeon-SL+ selecting
honest clusters while vanilla SL absorbs the poisoned updates: the settings
of ``examples/quickstart.py``, through ``repro_torch``'s public exports, on
the CUDA card unless ``--device cpu`` asks for the CPU.
"""
import argparse

from repro_torch.core import (GRADIENT, Attack, ProtocolConfig, from_cnn, run_pigeon,
                              run_vanilla_sl)
from repro_torch.data import build_image_task


def main(argv=None):
    """Runs both protocols; returns (Pigeon-SL+'s History, vanilla SL's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    data, cnn_cfg = build_image_task("mnist", m_clients=4, d_m=300, d_o=150,
                                     n_test=1000, seed=0)
    module = from_cnn(cnn_cfg)
    pcfg = ProtocolConfig(M=4, N=1, T=6, E=5, B=32, lr=0.05, seed=0)
    malicious = {1}
    attack = Attack(GRADIENT)

    print("=== Pigeon-SL+ (robust) ===")
    hist_p = run_pigeon(module, data, pcfg, malicious, attack, plus=True,
                        verbose=True, device=args.device)
    print("\n=== vanilla SL (baseline) ===")
    hist_v = run_vanilla_sl(module, data, pcfg, malicious, attack, verbose=True,
                            device=args.device)

    acc_p = hist_p.rounds[-1]["test_acc"]
    acc_v = hist_v.rounds[-1]["test_acc"]
    honest = sum(r["selected_honest"] for r in hist_p.rounds)
    print(f"\nfinal accuracy: pigeon+={acc_p:.3f}  vanilla={acc_v:.3f}")
    print(f"pigeon+ selected an honest cluster {honest}/{len(hist_p.rounds)} rounds")
    return hist_p, hist_v


if __name__ == "__main__":
    main()
