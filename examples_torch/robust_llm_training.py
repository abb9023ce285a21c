"""End-to-end driver: Pigeon-SL over a transformer language model, on the
PyTorch port (``examples/robust_llm_training.py``'s settings).

    PYTHONPATH=src python examples_torch/robust_llm_training.py [--device cpu]
        [--steps-per-client 4] [--rounds 4] [--d-model 256] [--layers 4]

Builds a small decoder LM, splits it at the cut layer, and runs the full
Pigeon-SL+ protocol over Markov-chain token data with one label-flipping
client: the same protocol code drives the paper's CNNs and every assigned
architecture.  On the CUDA card unless ``--device cpu`` asks for the CPU.
"""
import argparse
import time

from repro_torch import resolve_device
from repro_torch.core import LABEL_FLIP, Attack, ProtocolConfig, from_lm, run_pigeon
from repro_torch.data import build_lm_task
from repro_torch.models import ModelConfig, build_model


def main(argv=None):
    """Runs the protocol; returns its History."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--steps-per-client", type=int, default=4)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(
        name="pigeon-lm", arch_type="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(4, args.d_model // 64),
        n_kv_heads=max(2, args.d_model // 128), d_ff=4 * args.d_model,
        vocab=args.vocab, cut_layer=max(1, args.layers // 4))
    model = build_model(cfg, device)
    n_params = cfg.param_count()
    print(f"model: {cfg.n_layers}L d={cfg.d_model} vocab={cfg.vocab} "
          f"(~{n_params/1e6:.1f}M params), cut at block {cfg.cut_layer}")

    module = from_lm(model)
    data = build_lm_task(vocab=cfg.vocab, seq_len=args.seq,
                         m_clients=args.clients, d_m=128, d_o=48, n_test=48)
    pcfg = ProtocolConfig(M=args.clients, N=1, T=args.rounds,
                          E=args.steps_per_client, B=8, lr=3e-2, seed=0)
    t0 = time.time()
    hist = run_pigeon(module, data, pcfg, malicious={1}, attack=Attack(LABEL_FLIP),
                      plus=True, verbose=True, device=device)
    print(f"\nfinal next-token accuracy: {hist.rounds[-1]['test_acc']:.4f} "
          f"(uniform = {1/args.vocab:.4f}); wall {time.time()-t0:.0f}s")
    print("honest-cluster selections:",
          [r["selected_honest"] for r in hist.rounds])
    return hist


if __name__ == "__main__":
    main()
