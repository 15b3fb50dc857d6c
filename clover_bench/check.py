"""The comparison that decides ``correct``: served tokens against the
plain reference.

Once the window has closed and the program's state is freed, a sample of
the requests the run finished, drawn from the seed with the longest among
them, is run through the reference of the rung that served each one: one
forward over the prompt and the served tokens.  At every served position
the gap is how far the served token's logit lies below the reference's
best there, in units of that position's spread of logits (their standard
deviation), so that one limit reads alike across widths.  The number
compared is the widest gap over the sample (``gap_max``).

The control (``control.py``) puts the reference computed with fp8
products in the program's place: at the same positions of the same
sequences, the gap of the token that it puts first.
"""
from __future__ import annotations

import importlib.util
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent


def reference_module(family: str):
    """``reference/<family>.py``, loaded by path."""
    path = HERE / "reference" / f"{family}.py"
    spec = importlib.util.spec_from_file_location(f"bench_ref_{family}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pick_sample(finished: Sequence[Dict], seed: int, min_tokens: int,
                max_requests: int) -> List[Dict]:
    """The longest finished request (prompt and output) of each rung, then
    others drawn from the seed, until the served tokens reach
    ``min_tokens`` or the sample holds ``max_requests``."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-(len(r["prompt"])
                                              + len(r["tokens"])), r["rid"]))
    out, seen = [], set()
    for r in order:
        if r["variant"] not in seen:
            seen.add(r["variant"])
            out.append(r)
    taken = {r["rid"] for r in out}
    rest = [r for r in order if r["rid"] not in taken]
    rng = np.random.default_rng([int(seed), 0x5A3])
    rest = [rest[i] for i in rng.permutation(len(rest))]
    n = sum(len(r["tokens"]) for r in out)
    for r in rest:
        if n >= min_tokens or len(out) >= max_requests:
            break
        out.append(r)
        n += len(r["tokens"])
    return out


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: (best reference logit - the token's) / the logits'
    standard deviation there."""
    best = ref_logits.max(-1).values
    mine = ref_logits.gather(-1, tokens[:, None])[:, 0]
    return (best - mine) / ref_logits.std(-1)


def compare(sample: Sequence[Dict], rungs: Dict, model: Dict,
            device: torch.device, control: Optional[str] = None) -> Dict:
    """Reference gaps of the served tokens of ``sample`` (and, with
    ``control``, of the tokens that the reference in that precision puts
    first at the same positions).  ``rungs`` maps a rung's name to its
    (weights, layers); ``model["family"]`` names the reference."""
    ref = reference_module(model["family"])
    served_max, ctrl_max, n = 0.0, 0.0, 0
    for r in sample:
        w, n_layers = rungs[r["variant"]]
        p = np.asarray(r["prompt"], np.int64)
        out = np.asarray(r["tokens"], np.int64)
        seq = torch.as_tensor(np.concatenate([p, out[:-1]]), device=device)
        first = len(p) - 1
        lg = ref.logits(w, model, n_layers, seq, first)
        served = torch.as_tensor(out, device=device)
        served_max = max(served_max, float(gaps(lg, served).max()))
        if control is not None:
            lc = ref.logits(w, model, n_layers, seq, first, quant=control)
            ctrl_max = max(ctrl_max, float(gaps(lg, lc.argmax(-1)).max()))
            del lc
        n += len(out)
        del lg
    res = {"gap_max": served_max, "tokens": n, "requests": len(sample)}
    if control is not None:
        res["control_gap_max"] = ctrl_max
    return res
