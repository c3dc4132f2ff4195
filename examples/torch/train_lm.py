"""End-to-end driver on the PyTorch port: train a ~100M-param LM for a few
hundred steps with PFAIT train-until-target termination, async
checkpointing, and a restart demonstration (the twin of
``examples/train_lm.py``).

The model is a genuinely ~100M-param member of the qwen2 family (12 layers,
d_model 512, GQA kv=2, vocab 32k) — not the full 1.5B — so a few hundred
steps run in minutes.

Run:  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs.registry import get_arch
from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--target-loss", type=float, default=1.5)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args()

    # ~100M-param qwen2-family config
    base = get_arch("qwen2-1.5b")
    cfg100m = dataclasses.replace(
        base, num_layers=12, d_model=512, num_heads=8, num_kv_heads=2,
        head_dim=64, d_ff=2048, vocab_size=32_000,
    )
    print(f"model: {cfg100m.num_params()/1e6:.0f}M params "
          f"({cfg100m.num_layers}L d={cfg100m.d_model})")

    import repro_torch.configs.registry as registry

    registry.ARCHS["qwen2-100m"] = cfg100m
    with tempfile.TemporaryDirectory() as ckdir:
        out = train(
            "qwen2-100m", steps=args.steps, batch=args.batch, seq=args.seq,
            use_reduced=False, target_loss=args.target_loss,
            monitor_mode="pfait", staleness=4,
            ckpt_dir=ckdir, ckpt_every=100, log_every=20, device=args.device,
        )
        print(f"\nran {out['steps_run']} steps in {out['wall_s']:.0f}s "
              f"({out['steps_run']/max(out['wall_s'],1e-9):.2f} steps/s)")
        if out["stop_step"] is not None:
            print(f"PFAIT monitor stopped training at step {out['stop_step']} "
                  f"(target loss {args.target_loss})")
        else:
            print(f"final loss {out['losses'][-1]:.4f} "
                  f"(target {args.target_loss} not reached in {args.steps} steps)")


if __name__ == "__main__":
    main()
