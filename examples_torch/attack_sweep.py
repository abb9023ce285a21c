"""Attack sweep: the three paper attacks plus a heterogeneous mixed
population x {vanilla SL, Pigeon-SL, Pigeon-SL+}, printing a compact result
matrix, on the PyTorch port (``examples/attack_sweep.py``'s settings).  The
Pigeon rows run through the batched cluster-parallel engine; the mixed row
exercises the adversary subsystem's ``ThreatModel`` with one label flipper
plus one Byzantine gradient scaler.  Any two malicious clients exceed this
config's tolerance budget (M=4, N=1), so the pigeonhole honest-cluster
guarantee does NOT hold for the mixed row: it shows how selection degrades
beyond the budget.

    PYTHONPATH=src python examples_torch/attack_sweep.py [--device cpu]

On the CUDA card unless ``--device cpu`` asks for the CPU.
"""
import argparse

from repro_torch.core import (ACTIVATION, GRAD_SCALE, GRADIENT, LABEL_FLIP, Attack,
                              ProtocolConfig, ThreatModel, from_cnn, run_pigeon,
                              run_vanilla_sl)
from repro_torch.data import build_image_task


def main(argv=None):
    """Prints the matrix; returns {threat: (vanilla, pigeon, pigeon+) final
    test accuracy}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    data, cnn_cfg = build_image_task("mnist", m_clients=4, d_m=300, d_o=150,
                                     n_test=800, seed=0)
    module = from_cnn(cnn_cfg)
    pcfg = ProtocolConfig(M=4, N=1, T=5, E=5, B=32, lr=0.05, seed=0)

    rows = [(name, ThreatModel.build({1: Attack(kind)}))
            for name, kind in [("label_flip", LABEL_FLIP),
                               ("activation", ACTIVATION),
                               ("gradient", GRADIENT)]]
    rows.append(("mixed", ThreatModel.build({
        1: Attack(LABEL_FLIP),
        3: Attack(GRAD_SCALE, grad_scale=6.0),
    })))

    out = {}
    print(f"{'threat':12s} {'vanilla':>8s} {'pigeon':>8s} {'pigeon+':>8s}")
    for name, tm in rows:
        a_v = run_vanilla_sl(module, data, pcfg, threat_model=tm, device=args.device
                             ).rounds[-1]["test_acc"]
        a_p = run_pigeon(module, data, pcfg, threat_model=tm, engine="batched",
                         device=args.device).rounds[-1]["test_acc"]
        a_pp = run_pigeon(module, data, pcfg, threat_model=tm, plus=True, engine="batched",
                          device=args.device).rounds[-1]["test_acc"]
        print(f"{name:12s} {a_v:8.3f} {a_p:8.3f} {a_pp:8.3f}")
        out[name] = (a_v, a_p, a_pp)
    return out


if __name__ == "__main__":
    main()
