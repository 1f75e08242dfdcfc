"""Production training launcher.

Port of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \\
        --global-batch 4 --seq 8192          # full config, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 20 --smoke --device cpu      # reduced config, on the CPU

The same loop as the reference's: random weights from seed 0,
``adamw(linear_warmup_cosine(3e-4, 10, steps), weight_decay=0.01)``,
``make_train_step(cfg, opt, ssd_chunk=32)``, the deterministic token
pipeline (``SyntheticTokens``, seed 11), an async ``CheckpointManager``
that resumes from its latest step, a checkpoint every ``--ckpt-every`` steps
and at the end, and the straggler watchdog.  It runs eagerly on the card
unless ``--device cpu`` is given.  Beside the reference's prints, each step
prints its wall time (synchronised), tokens/s and the card's peak allocated
memory.  ``--ckpt-every 0`` (the port's own) writes no checkpoint at all,
for a run whose state is too large to be worth writing.  ``main`` returns a
``TrainResult``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, NamedTuple

import torch

__all__ = ["TrainResult", "main"]


class TrainResult(NamedTuple):
    start: int               # the step it resumed from (0: a fresh run)
    losses: List[float]      # per step run
    grad_norms: List[float]
    walls: List[float]       # seconds per step, synchronised
    tok_s: List[float]       # global_batch · seq / wall
    peak_bytes: int          # torch.cuda.max_memory_allocated (0 on the CPU)
    state: object            # the final TrainState


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints; 0 writes none")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .._device import resolve_device
    from ..checkpoint import CheckpointManager
    from ..configs import get
    from ..data import DataConfig, SyntheticTokens
    from ..distributed import StragglerWatchdog
    from ..models import TrainState, init_params, make_train_step
    from ..optim import adamw, linear_warmup_cosine

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    spec = get(args.arch)
    cfg = spec.smoke_config if args.smoke else spec.config
    where = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"training {cfg.name}: {cfg.num_params()/1e6:.1f}M params, "
          f"1 device ({where})")

    opt = adamw(linear_warmup_cosine(3e-4, 10, args.steps), weight_decay=0.01)
    step_fn = make_train_step(cfg, opt, ssd_chunk=32)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.global_batch,
                                      seed=11), device)
    ckpt = args.ckpt_every > 0
    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True) \
        if ckpt else None
    params = init_params(cfg, seed=0, device=device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    start = (mgr.latest_step() or 0) if ckpt else 0
    if start:
        state = mgr.restore(start, state)
        print(f"resumed from step {start}")
    wd = StragglerWatchdog()
    tokens = args.global_batch * args.seq
    losses, norms, walls, rates = [], [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    metrics = None
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = step_fn(state, data.batch(step))
            loss = float(metrics["loss"])          # synchronises
            wall = time.perf_counter() - t0
            if wd.record(step, wall):
                print(f"[watchdog] slow step {step}")
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            walls.append(wall)
            rates.append(tokens / wall)
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            if step % 10 == 0:
                print(f"step {step} loss {loss:.4f}")
            print(f"step {step}: loss {loss:.6f} grad_norm {norms[-1]:.6f} "
                  f"wall {wall * 1e3:.1f} ms {rates[-1]:.0f} tok/s peak "
                  f"{peak / 2**30:.2f} GiB")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state)
        if ckpt:
            mgr.save(args.steps, state)
            mgr.wait()
    finally:
        if mgr is not None:
            mgr.close()
    if metrics is not None:
        print(f"done; final loss {float(metrics['loss']):.4f}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    return TrainResult(start, losses, norms, walls, rates, peak, state)


if __name__ == "__main__":
    main()
