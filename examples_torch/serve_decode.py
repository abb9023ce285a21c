"""Batched serving demo: KV-cache decode across architecture families, on
the PyTorch port (``examples/serve_decode.py``'s settings).

    PYTHONPATH=src python examples_torch/serve_decode.py [--device cpu]

Greedy-decodes batched prompts through smoke-scale variants of three
families (dense GQA, Mamba2 hybrid, MLA+MoE) with ``Model.decode_step`` and
its cache, in place of the reference's ``jax.jit`` of it: the step the
serve launcher runs for decode_32k / long_500k.  On the CUDA card unless
``--device cpu`` asks for the CPU.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.data import make_markov_tokens
from repro_torch.models import build_model


@torch.inference_mode()
def decode_demo(arch: str, device, batch=4, prompt_len=12, new_tokens=20):
    """Steps the prompt through the cache, then decodes greedily; returns
    the generated tokens (batch, new_tokens)."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device).init(torch.Generator(device=device).manual_seed(0))
    cache = model.init_cache(batch, prompt_len + new_tokens)
    prompts = torch.from_numpy(make_markov_tokens(0, cfg.vocab, batch, prompt_len)).to(device)
    t0 = time.time()
    logits = None
    for i in range(prompt_len):
        logits, cache = model.decode_step(cache, prompts[:, i:i + 1], i)
    toks = []
    for j in range(new_tokens):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        toks.append(nxt)
        logits, cache = model.decode_step(cache, nxt, prompt_len + j)
    gen = torch.cat(toks, 1).cpu().numpy()          # waits for the device
    dt = time.time() - t0
    rate = batch * (prompt_len + new_tokens) / dt
    print(f"{arch:24s} [{cfg.arch_type:6s}] {rate:8.1f} tok/s  "
          f"sample: {gen[0][:10].tolist()}")
    return gen


def main(argv=None):
    """Decodes the three families; returns {arch: generated tokens}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"device: {where}")
    out = {}
    for arch in ("qwen3-8b", "zamba2-1.2b", "deepseek-v2-lite-16b"):
        out[arch] = decode_demo(arch, device)
    return out


if __name__ == "__main__":
    main()
