"""Serving launcher: batched greedy autoregressive decode with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen3-8b --batch 4 --prompt-len 16 --new-tokens 32

On the CUDA card by default (``--device cpu`` asks for the CPU).  The smoke
config (``reduce_config``) is the default, as in the reference; ``--full``
serves the published config at the decode shape's settings (bf16), with
its weights drawn on the card.  As in the reference, the prompt is stepped
through the decode path one position at a time, then ``--new-tokens``
tokens are decoded greedily.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config, list_archs
from ..data import make_markov_tokens
from ..models import build_model
from ..models.config import ModelConfig
from .shapes import SHAPES, shape_settings
from .steps import make_serve_step

#: largest vocabulary whose prompts come from the Markov chain, which holds
#: a dense (vocab, vocab) f64 matrix (128 MB here; 185 GB at Qwen3's vocab)
MARKOV_MAX_VOCAB = 4096


def serve_config(arch: str, full: bool = False) -> ModelConfig:
    """The smoke config of ``arch``, or with ``full`` the published one at
    the decode shape's execution settings (bf16)."""
    if not full:
        return get_smoke_config(arch)
    return dataclasses.replace(get_config(arch), **shape_settings(SHAPES["decode_32k"]))


def make_prompts(seed: int, vocab: int, batch: int, prompt_len: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts: the reference's Markov tokens up to
    :data:`MARKOV_MAX_VOCAB`, uniform tokens from the same seed beyond."""
    if vocab <= MARKOV_MAX_VOCAB:
        return make_markov_tokens(seed, vocab, batch, prompt_len)
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, size=(batch, prompt_len)).astype(np.int32)


@torch.inference_mode()
def greedy_decode(serve_step: Callable, cache, prompts: torch.Tensor, new_tokens: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's serve loop: step the prompt (B, P) through
    ``serve_step`` at positions 0..P-1, then decode ``new_tokens`` tokens
    greedily.  Returns (generated (B, new_tokens) on the device, the logits
    (B, 1, V) of the prompt's last position)."""
    prompt_len = prompts.shape[1]
    logits = None
    for i in range(prompt_len):
        logits, cache = serve_step(cache, prompts[:, i:i + 1], i)
    prompt_logits = logits
    generated = []
    for j in range(new_tokens):
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        generated.append(tok)
        logits, cache = serve_step(cache, tok, prompt_len + j)
    return torch.cat(generated, dim=1), prompt_logits


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="serve the published config (bf16) instead of the smoke one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="a JSONL span trace of every decode step (not ported yet)")
    args = ap.parse_args(argv)
    if args.trace:
        raise NotImplementedError("serve --trace: telemetry is ROADMAP.md Queue A item 8")

    device = resolve_device(args.device)
    cfg = serve_config(args.arch, args.full)
    model = build_model(cfg, device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    max_seq = args.prompt_len + args.new_tokens
    cache = model.init_cache(args.batch, max_seq)
    prompts = make_prompts(args.seed, cfg.vocab, args.batch, args.prompt_len)

    t0 = time.perf_counter()
    gen, _ = greedy_decode(make_serve_step(model), cache,
                           torch.from_numpy(prompts).to(device), args.new_tokens)
    gen = gen.cpu().numpy()                  # waits for the device
    elapsed = time.perf_counter() - t0
    total_tokens = args.batch * max_seq
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"new={args.new_tokens} dtype={cfg.dtype}")
    print(f"throughput: {total_tokens / elapsed:.1f} tok/s ({where})")
    for b in range(min(args.batch, 2)):
        print(f"  sample[{b}]: prompt={prompts[b].tolist()} -> {gen[b][:16].tolist()}...")


if __name__ == "__main__":
    main()
