"""Serving launcher: batched prefill + greedy decode.

Port of ``repro/launch/serve.py``:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
        --smoke --device cpu

Random weights from seed 0 and random prompts from seed 1.  Runs on the card
unless ``--device cpu`` is given.  ``main`` returns the generated tokens and
the timings.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

__all__ = ["ServeResult", "main"]


class ServeResult(NamedTuple):
    tokens: torch.Tensor     # (batch, steps) int32 greedy tokens
    prefill_ms: float        # host clock around prefill, synchronised
    decode_ms: float         # host clock around steps-1 decode steps
    decode_tok_s: float      # batch·(steps-1) / decode time


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")

    from .._device import resolve_device
    from ..configs import get
    from ..models import init_params, make_serve_step, prefill

    device = resolve_device(args.device)
    spec = get(args.arch)
    cfg = spec.smoke_config if args.smoke else spec.config
    with torch.inference_mode():
        params = init_params(cfg, seed=0, device=device)
        serve_step = make_serve_step(cfg)
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                                generator=gen, dtype=torch.int32).to(device)
        max_len = args.prompt + args.steps
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, prompts, max_len=max_len,
                                 ssd_chunk=32)
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        print(f"prefill {args.batch}×{args.prompt}: {prefill_ms:.1f} ms")
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.steps - 1):
            tok, logits, caches = serve_step(params, caches, tok,
                                             args.prompt + i)
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    n_dec = args.batch * (args.steps - 1)
    tok_s = n_dec / decode_s if decode_s > 0 else 0.0
    print(f"decode {args.steps - 1} steps: {decode_s * 1e3:.1f} ms "
          f"({tok_s:.0f} tok/s)")
    return ServeResult(torch.cat(out, dim=1).cpu(), prefill_ms,
                       decode_s * 1e3, tok_s)


if __name__ == "__main__":
    main()
