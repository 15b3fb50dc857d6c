#!/usr/bin/env python3
"""What ``chip_smoke.py``'s MoE prefill check reads, and why: the readings
that its ``MOE_PREFILL_TOL`` limits sit between.

    PYTHONPATH=src:. python3 scripts/moe_prefill_sensitivity.py

Needs one GPU.  For qwen3-moe-30b-a3b at full width (weights from seed 0)
it holds the chunked paged prefill of ``chip_smoke``'s 1400-token prompt
(chunks of 128, f32 arena) to ``registry.forward`` over the same prompt,
both at a drop-free capacity (``capacity_factor = E / k``), as a fraction
of the rms of the layers' part of the forward's logits — as is, with
unnormalised gates, and with the chunked prefill at the config's own
capacity — in f32 at 2 layers, and in bf16 at 2 and 48 layers.  For each
it also prints, layer by layer, the share of the prompt's tokens whose
set of chosen experts differs between the two paths: a token whose
router scores a near-tie can choose another expert when its hidden state
moves by a rounding, and that changes its output by about one expert's
share.
"""
from __future__ import annotations

import contextlib

import torch

import chip_smoke
from repro_torch.configs import qwen3_moe_30b_a3b
from repro_torch.models import moe as M
from repro_torch.models import registry as R


def _routing(model, prompt, cfg):
    """The sorted expert sets of every layer for the prompt's tokens: in
    the forward and in the chunked prefill."""
    route, log = M._route, []

    def recording(p, x, c):
        out = route(p, x, c)
        log.append(out[2].reshape(-1, c.top_k).sort(-1).values)
        return out

    M._route = recording
    try:
        R.forward(model, {"tokens": torch.as_tensor(prompt[None],
                                                    device="cuda")}, cfg)
        fwd = list(log)
        log.clear()
        chip_smoke._chunked_prefill_logits(model, prompt, 128)
        chunks = list(log)
    finally:
        M._route = route
    L, n = cfg.n_layers, len(prompt)
    return [(fwd[li][:n] != torch.cat(chunks[li::L])[:n]).any(-1)
            .float().mean().item() for li in range(L)]


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.phase_device_build())
    prompt = chip_smoke._dense_prompts(
        qwen3_moe_30b_a3b.FULL.vocab_size,
        lengths=chip_smoke.MOE_LENGTHS)[1]
    for dtype, depth in ((torch.float32, 2), (torch.bfloat16, 2),
                         (torch.bfloat16, 48)):
        cfg = qwen3_moe_30b_a3b.FULL.with_(n_layers=depth, dtype=dtype)
        model = R.init_params(cfg, seed=0)
        free = cfg.with_(capacity_factor=cfg.padded_experts / cfg.top_k)

        @contextlib.contextmanager
        def own_capacity():
            model.cfg = cfg
            try:
                yield
            finally:
                model.cfg = free

        model.cfg = free
        r = chip_smoke._prefill_vs_forward(
            model, prompt, 128,
            {"kept": contextlib.nullcontext,
             "unnormalised": chip_smoke._unnormalised_gates,
             "own capacity": own_capacity}, 0)
        flips = _routing(model, prompt, free)
        print(f"{str(dtype)[6:]} {depth} layers: kept {r['kept']:.4g}, "
              f"unnormalised gates {r['unnormalised']:.4g}, own capacity "
              f"{r['own capacity']:.4g}; tokens whose experts differ, by "
              f"layer: {' '.join(f'{x:.4f}' for x in flips)}", flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
