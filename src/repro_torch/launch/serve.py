"""Serving launcher: batched prefill + greedy decode.

Port of ``repro/launch/serve.py``; every arch of the registry serves:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \\
        --smoke --device cpu

Random weights from seed 0 and random prompts from seed 1; a VLM serves its
text path (no vision embeds), as the reference's launcher does.  Runs on the
card unless ``--device cpu`` is given.  ``main`` returns the generated tokens
and the timings; ``serve`` does the same for a config the caller built (a
registered one cut to fit a card, or with ``quantize_weights=True``).

With ``cfg.quantize_weights`` the weights are int8 with f32 scales
(``models/quantize.py``), the reference's serving dry run's
``quantize_params(init_params(cfg))``: built leaf by leaf, each drawn as
``init_params`` draws it and quantized at once, so no bf16 tree is ever
resident, and dequantized one sub-layer (an MoE layer one expert) at a
time as the model runs.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

__all__ = ["ServeResult", "main", "serve"]


class ServeResult(NamedTuple):
    tokens: torch.Tensor     # (batch, steps) int32 greedy tokens
    prefill_ms: float        # host clock around prefill, synchronised
    decode_ms: float         # host clock around steps-1 decode steps
    decode_tok_s: float      # batch·(steps-1) / decode time
    weight_bytes: int        # bytes of the weights on the device (int8 data
    #                          and f32 scales when quantized)


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

    from ..configs import get
    spec = get(args.arch)
    return serve(spec.smoke_config if args.smoke else spec.config,
                 args.batch, args.prompt, args.steps, args.device)


def serve(cfg, batch: int, prompt: int, steps: int,
          device="cuda") -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt`` tokens with ``cfg``'s
    random weights (int8 with ``cfg.quantize_weights``), then decode
    greedily to ``steps`` tokens each."""
    from .._device import resolve_device
    from ..models import (init_params, init_quantized_params,
                          make_serve_step, prefill)
    from ..models.params import tree_leaves

    device = resolve_device(device)
    with torch.inference_mode():
        init = init_quantized_params if cfg.quantize_weights else init_params
        params = init(cfg, seed=0, device=device)
        if cfg.quantize_weights and device.type == "cuda":
            # hand back the blocks of the full-size f32 draws the int8 tree
            # was quantized from, so the prefill's large blocks do not have
            # to fit between them
            torch.cuda.empty_cache()
        weight_bytes = sum(a.numel() * a.element_size()
                           for a in tree_leaves(params))
        serve_step = make_serve_step(cfg)
        gen = torch.Generator().manual_seed(1)
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=gen, dtype=torch.int32).to(device)
        max_len = prompt + steps
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, prompts, max_len=max_len,
                                 ssd_chunk=32)
        tok = torch.argmax(logits[:, -1:, :], dim=-1).to(torch.int32)
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        print(f"prefill {batch}×{prompt}: {prefill_ms:.1f} ms")
        del logits
        out = [tok]
        t0 = time.perf_counter()
        for i in range(steps - 1):
            tok, _, caches = serve_step(params, caches, tok, prompt + i)
            out.append(tok)
        _sync(device)
        decode_s = time.perf_counter() - t0
    n_dec = batch * (steps - 1)
    tok_s = n_dec / decode_s if decode_s > 0 else 0.0
    print(f"decode {steps - 1} steps: {decode_s * 1e3:.1f} ms "
          f"({tok_s:.0f} tok/s)")
    return ServeResult(torch.cat(out, dim=1).cpu(), prefill_ms,
                       decode_s * 1e3, tok_s, weight_bytes)


if __name__ == "__main__":
    main()
