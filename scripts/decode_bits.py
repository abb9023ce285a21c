"""B6's outputs on the card, saved or held bit for bit against a saved set.

The tensor-core kernel (``decode_attention``, and its partial mode over two
panels) runs at ``chip_smoke.py``'s ``DECODE_SHAPES`` and ``DECODE_LONG`` of
head dims 64 and 128, bf16, each with a host index and a device index; the
outputs go to OUT.  With ``--against FILE`` (another checkout's OUT) every
output must equal FILE's bit for bit, so a change to the kernel at other
head dims can show that it kept these bits.

The kernels that run are those of the checkout in the working directory,
so one copy of this script serves two checkouts:

    (cd PARENT && python3 ROOT/scripts/decode_bits.py /tmp/parent.pt)
    python3 scripts/decode_bits.py /tmp/new.pt --against /tmp/parent.pt
"""
import argparse
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="where the outputs are saved (torch.save)")
    ap.add_argument("--against", help="a saved set the outputs must equal bit for bit")
    args = ap.parse_args()
    root = Path.cwd()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da
    if not torch.cuda.is_available():
        sys.exit("decode_bits: no CUDA device")

    shapes = [s for s in cs.DECODE_SHAPES + (cs.DECODE_LONG,) if s[4] in (64, 128)]
    outs = {}
    with torch.inference_mode():
        for i, shape in enumerate(shapes):
            (q, k, v, index), kw = cs._attention_args("decode_attention", shape, "bfloat16",
                                                      seed=i)
            dev = torch.tensor(index, dtype=torch.int32, device=q.device)
            for form, idx in (("host", index), ("device", dev)):
                outs[f"{shape} {form}"] = da.decode_attention(q, k, v, idx, **kw).cpu()
                ks, length = cs._panels(k, 2)
                vs, _ = cs._panels(v, 2)
                for j in range(2):
                    o, lse = da.decode_attention_partial(q, ks[j].contiguous(),
                                                         vs[j].contiguous(), idx,
                                                         base=j * length, **kw)
                    outs[f"{shape} {form} panel {j}"] = torch.cat(
                        [o.flatten(), lse.flatten()]).cpu()
    torch.save(outs, args.out)
    print(f"decode_bits: {len(outs)} outputs of {len(shapes)} shapes from {root}", flush=True)
    if args.against:
        old = torch.load(args.against)
        differ = [key for key in outs if key not in old or not torch.equal(old[key], outs[key])]
        print(f"decode_bits: {len(outs) - len(differ)} of {len(outs)} bit-equal to "
              f"{args.against}; differ: {differ}", flush=True)
        if differ or len(old) != len(outs):
            sys.exit(1)


if __name__ == "__main__":
    main()
