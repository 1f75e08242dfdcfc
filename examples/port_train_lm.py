"""End-to-end training script of the PyTorch port, with checkpoint/restart.

The port's counterpart of ``examples/train_lm.py``: a ~13M-parameter
qwen-family model on the deterministic synthetic pipeline, loss well below
the unigram entropy after a few hundred steps.  Kill it at any point and
re-run: it resumes from the latest checkpoint and replays the same data.

    PYTHONPATH=src python examples/port_train_lm.py [--steps 200] \\
        [--ckpt-dir d] [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import StragglerWatchdog
from repro_torch.models import (ModelConfig, TrainState, init_params,
                                make_train_step)
from repro_torch.optim import adamw, linear_warmup_cosine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ModelConfig(name="qwen-mini", n_layers=4, d_model=256, n_heads=8,
                      n_kv_heads=8, d_ff=1024, vocab_size=32768,
                      qkv_bias=True, tie_embeddings=True, remat=False,
                      dtype="float32")
    print(f"model: {cfg.num_params()/1e6:.1f}M params on {device}")

    opt = adamw(linear_warmup_cosine(3e-4, 20, args.steps), b1=0.9,
                weight_decay=0.01)
    train_step = make_train_step(cfg, opt)
    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch, seed=17),
                           device)

    mgr = CheckpointManager(args.ckpt_dir, keep=2, async_save=True)
    params = init_params(cfg, seed=0, device=device)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32))
    start = 0
    if mgr.latest_step() is not None:
        start = mgr.latest_step()
        state = mgr.restore(start, state)
        print(f"resumed from checkpoint at step {start}")

    watchdog = StragglerWatchdog(threshold=3.0)
    losses = []
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            state, metrics = train_step(state, data.batch(step))
            loss = float(metrics["loss"])            # synchronises
            dt = time.perf_counter() - t0
            losses.append(loss)
            if watchdog.record(step, dt):
                print(f"  [watchdog] slow step {step}: {dt:.2f}s")
            if step % 20 == 0 or step == args.steps - 1:
                print(f"step {step:4d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f} ms")
            if (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, state, meta={"loss": loss})
        mgr.wait()
    finally:
        mgr.close()
    print(f"final checkpoint at step {mgr.latest_step()}; "
          f"straggler events: {len(watchdog.flagged)}")
    return losses


if __name__ == "__main__":
    main()
