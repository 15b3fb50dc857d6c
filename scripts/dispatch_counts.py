"""Count the ATen operations that one unsharded paged decode dispatch (two
fused steps) and one paged prefill chunk dispatch, per operation, on the
SMOKE qwen3-1.7b and qwen3-moe configs at 2 layers, and one single-device
training step (forward, backward and AdamW) of the SMOKE qwen3-1.7b and
mamba2-2.7b configs, on the CPU.  Host cost in eager PyTorch grows with
the number of dispatched operations, so two trees that dispatch the same
operations on these paths add no host work there.  Prints one JSON
object: {entry: {"total": n, "ops": {op: n}}}.

    PYTHONPATH=src python3 scripts/dispatch_counts.py
    python3 scripts/dispatch_counts.py --src build/parent/src

Compare a parent tree with ``git archive <commit> src | tar -x -C DIR``.
"""
import argparse
import collections
import json
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=None,
                    help="the tree's src directory (default: PYTHONPATH)")
    args = ap.parse_args()
    if args.src:
        sys.path.insert(0, args.src)
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import registry as R

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n[str(func)] += 1
            return func(*args, **(kwargs or {}))

    torch.manual_seed(0)
    out = {}
    for arch in ("qwen3-1.7b", "qwen3-moe-30b-a3b"):
        cfg = get_smoke_config(arch).with_(n_layers=2)
        model = R.init_params(cfg, device="cpu")
        arena = R.make_block_arena(cfg, 16, 8, device="cpu")
        b = 4
        tables = torch.arange(1, 1 + 2 * b, dtype=torch.int32).reshape(b, 2)
        lengths = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
        with Count() as c:
            R.decode_paged_multi(
                model, arena, {"tokens": torch.ones((b, 1), dtype=torch.int32)},
                tables, lengths, torch.ones(b, dtype=torch.bool), 2)
        out[f"{arch} decode x2"] = c.n
        with Count() as c:
            R.prefill_paged(model, {"tokens": torch.ones((1, 16),
                                                         dtype=torch.int32)},
                            arena, torch.arange(1, 3, dtype=torch.int32),
                            0, 13)
        out[f"{arch} prefill"] = c.n
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_loop as TL
    opt = O.AdamWConfig(lr=1e-3)
    for arch in ("qwen3-1.7b", "mamba2-2.7b"):
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        state = TL.make_train_state(R.init_params(cfg, device="cpu"), opt)
        g = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=g)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        step = TL.make_train_step(cfg, opt)
        with Count() as c:
            step(state, batch)
        out[f"{arch} train step"] = c.n
    print(json.dumps({k: {"total": sum(n.values()), "ops": dict(sorted(
        n.items()))} for k, n in out.items()}))


if __name__ == "__main__":
    main()
