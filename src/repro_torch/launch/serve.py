"""LM serving with the paper's detection at batch level (port of the LM
serving loop of ``launch/serve.py``): batched prefill, then greedy decode that
stops on a K-stale "all sequences finished" indicator through the PFAIT
monitor.

The multi-tenant ``DetectionService`` of the same JAX module is a later
slice (ROADMAP queue 1 item 11).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike
from repro_torch.configs.base import reduced as reduced_cfg
from repro_torch.configs.registry import get_arch
from repro_torch.core import detection
from repro_torch.models.model import Model
from repro_torch.models.transformer import Transformer


def make_prompts(vocab_size: int, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """The JAX server's prompts: ``default_rng(seed).integers(3, vocab)``."""
    rng = np.random.default_rng(seed)
    return rng.integers(3, vocab_size, (batch, prompt_len)).astype(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: Model, params: Transformer, prompts, max_new: int, eos_id: int = 2,
             staleness: int = 4) -> Dict[str, Any]:
    """Prefill ``prompts`` [B, S], then greedy-decode up to ``max_new``
    tokens, stopping when the PFAIT monitor sees the K-stale indicator
    g = 1 − [all finished] under ε = 0.5.

    Returns the JAX ``serve`` dict — ``tokens`` [B, ≤ max_new] with the
    tokens past each sequence's first EOS drained to ``eos_id``,
    ``finished``, ``steps`` (decode steps run), ``stopped_by``
    ("detector" or "budget"), ``wall_s``, ``tok_per_s`` — plus the wall
    time of the prefill (``prefill_s``) and of the decode loop
    (``decode_s``), and ``logits_finite``: no NaN or inf in any logits of
    the run (a device-side flag read once, at the end).  The KV cache is
    allocated once at S + ``max_new`` and written in place.
    """
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts)).long().to(dev)
    batch, prompt_len = prompts.shape
    prefill = model.make_prefill()
    decode = model.make_decode_step()

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, max_len=prompt_len + max_new)
    tok = logits[:, -1].argmax(dim=-1)  # [B]
    finite = logits.isfinite().all()
    _sync(dev)
    t_prefill = time.perf_counter()
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    generated = [tok]
    # K-stale termination (PFAIT monitor): g = 1 − [all finished] ∈ {0, 1},
    # ε = 0.5, so the monitor fires when the flag launched K steps ago was
    # set — the loop never waits on the fresh flag
    mon = detection.MonitorConfig(mode="pfait", eps=0.5, staleness=staleness,
                                  ord=float("inf"))
    mstate = detection.init_state(mon, dev)
    steps_done = 0
    stopped_by = "budget"
    for i in range(max_new - 1):
        logits, cache = decode(params, cache, tok[:, None], prompt_len + i)
        tok = logits[:, -1].argmax(dim=-1)
        finite = finite & logits.isfinite().all()
        finished = finished | (tok == eos_id)
        generated.append(tok)
        g = 1.0 - finished.all().float()
        mstate = detection.step(mon, mstate, g)
        steps_done = i + 1
        if bool(detection.should_stop(mstate)):   # stale view only
            stopped_by = "detector"
            break
    toks = torch.stack(generated, dim=1).cpu().numpy().astype(np.int32)
    # drain: mask the ≤ K tokens generated past each sequence's first EOS —
    # the stale detector deliberately over-runs, the report must not leak
    # the over-run tokens as real output
    eos_hits = toks == eos_id
    past_eos = np.cumsum(np.cumsum(eos_hits, axis=1), axis=1) > 1
    toks = np.where(past_eos, eos_id, toks)
    fin = finished.cpu().numpy()
    t_end = time.perf_counter()
    wall = t_end - t0
    return {
        "tokens": toks,
        "finished": fin,
        "steps": steps_done,
        "stopped_by": stopped_by,
        "wall_s": wall,
        "tok_per_s": batch * steps_done / max(wall, 1e-9),
        "prefill_s": t_prefill - t0,
        "decode_s": t_end - t_prefill,
        "logits_finite": bool(finite),
    }


def serve(
    arch: str,
    batch: int = 4,
    prompt_len: int = 32,
    max_new: int = 32,
    use_reduced: bool = True,
    eos_id: int = 2,
    staleness: int = 4,
    seed: int = 0,
    greedy: bool = True,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Batched prefill + decode of ``arch`` with seed-initialised weights,
    on the card unless ``device`` says otherwise; see ``generate`` for the
    loop and the returned dict.  Decoding is greedy (``greedy`` is kept for
    the JAX signature)."""
    cfg = get_arch(arch)
    if use_reduced:
        cfg = reduced_cfg(cfg)
    model = Model(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    prompts = make_prompts(cfg.vocab_size, batch, prompt_len, seed)
    return generate(model, params, prompts, max_new, eos_id=eos_id, staleness=staleness)


def main() -> None:
    """CLI: LM decode serving (the JAX CLI's LM branch)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    # as in the JAX CLI: store_true with default True, so always reduced
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                max_new=args.max_new, use_reduced=args.reduced, device=args.device)
    print(f"[serve] generated {out['tokens'].shape} in {out['wall_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s, stopped by {out['stopped_by']})")


if __name__ == "__main__":
    main()
