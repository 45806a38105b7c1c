"""End-to-end training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 200 --batch 16 --seq 64 --ckpt-dir /tmp/ckpt \\
        --device cpu

Runs on the CUDA card; ``--device cpu`` names the CPU explicitly (without
it and with no card, it raises). ``--reduced`` trains the smoke-scale
config; without it, the full config on the one device. The step runs
eagerly (the reference jits it and donates the state).

Fault tolerance: checkpoints every --ckpt-every steps (async, atomic);
``--resume`` continues from the latest checkpoint with an exactly-replayed
data stream (batch ``i`` is ``lm_batch(cfg, batch, seq, seed, i)``).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data import pipeline as pipe
from repro_torch.models import transformer as T
from repro_torch.train import CheckpointManager, ErrorFeedbackCompressor, make_train_step
from repro_torch.train.train_step import default_optimizer, lm_loss_fn


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (an error "
                         "without one)")
    args = ap.parse_args(argv)

    mod = get_arch(args.arch)
    cfg = mod.reduced() if args.reduced else mod.CONFIG
    if not hasattr(cfg, "n_layers") or not hasattr(cfg, "vocab"):
        raise SystemExit(f"--arch {args.arch}: this launcher trains the LM "
                         "archs; train the others with make_train_step and "
                         "their loss closures")
    dev = resolve_device(args.device)

    params = T.init_lm(torch.Generator(device=dev).manual_seed(args.seed),
                       cfg, device=dev)
    opt = default_optimizer(cfg)
    comp = ErrorFeedbackCompressor(enabled=args.compress_grads)
    init_fn, step = make_train_step(lm_loss_fn(cfg), opt, comp)
    state = init_fn(params)
    del params

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if args.resume and mgr and mgr.latest_step() is not None:
        state, manifest = mgr.restore(state)
        start = manifest["step"]
        print(f"resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = {"tokens": pipe.lm_batch(cfg, args.batch, args.seq,
                                         args.seed, i)["tokens"]}
        state, metrics = step(state, batch)
        if (i + 1) % args.log_every == 0:
            print(f"step {i+1:5d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{(i + 1 - start) / (time.time() - t0):.2f} it/s")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, state, extra={"seed": args.seed}, blocking=False)
    if mgr:
        mgr.save(args.steps, state, extra={"seed": args.seed})
        mgr.wait()
    print("done.")


if __name__ == "__main__":
    main()
