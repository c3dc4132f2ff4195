"""Serving example on the PyTorch port: batched prefill + decode across
cache families.

Runs three backbone families (GQA transformer, pure SSM, hybrid windowed-
attention+SSM) through the same serving driver — the decode loop's
termination check is K-stale (PFAIT-style, see launch/serve.py).  The twin
of ``examples/serve_lm.py``; on the card the prefill's attention runs the
flash kernel.

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import serve


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    device = ap.parse_args().device
    for arch in ("qwen2-1.5b", "mamba2-130m", "hymba-1.5b"):
        out = serve(arch, batch=4, prompt_len=32, max_new=24, use_reduced=True,
                    device=device)
        print(f"{arch:14s} tokens {tuple(out['tokens'].shape)} "
              f"steps={out['steps']:3d} {out['tok_per_s']:7.1f} tok/s "
              f"finished={out['finished'].sum()}/{len(out['finished'])}")


if __name__ == "__main__":
    main()
