"""Training driver on the port — the counterpart of the reference
package's ``launch/train.py``: real training of a (reduced) architecture
with checkpoint/restart fault tolerance and the whole substrate (AdamW,
schedule, gradient accumulation, asynchronous checkpoints, deterministic
data).  The model is the arch's SMOKE config in f32, weights from seed 0;
it runs on the GPU unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 200 --ckpt-dir /tmp/ckpt [--resume] [--simulate-crash-at 100]
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="depth/width scale of the smoke config")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-crash-at", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (the GPU by default; cpu to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry as R
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if args.scale != 1.0:
        cfg = cfg.with_(n_layers=max(int(cfg.n_layers * args.scale), 1))
    cfg = cfg.with_(dtype=torch.float32)
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps)

    ds = DATA.SyntheticLM(DATA.DataConfig(cfg.vocab_size, args.seq,
                                          args.batch))
    start_step = 0
    state = TL.make_train_state(R.init_params(cfg, seed=0, device=dev),
                                opt_cfg)
    if args.resume and CKPT.latest_step(args.ckpt_dir) is not None:
        start_step = CKPT.latest_step(args.ckpt_dir)
        state = CKPT.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start_step}")

    if args.accum > 1:
        step_fn = TL.make_grad_accum_train_step(cfg, opt_cfg, args.accum)
    else:
        step_fn = TL.make_train_step(cfg, opt_cfg)
    ckpt = CKPT.AsyncCheckpointer(args.ckpt_dir, keep=3)

    t0 = time.perf_counter()
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps from {start_step}")
    for step, batch in zip(range(start_step, args.steps),
                           ds.batches(start_step)):
        state, m = step_fn(state, DATA.to_device(batch, dev))
        if args.simulate_crash_at and step + 1 == args.simulate_crash_at:
            ckpt.submit(state, step + 1)
            ckpt.wait()
            print(f"[train] simulated crash at step {step + 1} "
                  f"(checkpoint durable; rerun with --resume)")
            return 0
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            ckpt.submit(state, step + 1)
        if (step + 1) % 20 == 0 or step == start_step:
            dt = time.perf_counter() - t0
            print(f"[train] step {step+1:5d} loss={float(m['loss']):.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                  f"({dt:.0f}s)", flush=True)
    ckpt.close()
    print(f"[train] done: final loss {float(m['loss']):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
