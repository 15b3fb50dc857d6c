"""The dense decoder (qwen3, glm4) as the benchmark makes and counts it:
the weights it draws, the port's names for them, and the operations of
one token through its projections.  A family of the port is served by a
file of this name under ``families/`` that defines the same three
functions; the config file's ``model.family`` names it.  Nothing here
imports the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

# spreads: every product's weight, the norms' scales (about 1), the biases.
# N(0, 0.02) products keep every layer's share of the logits: with an
# embedding of spread 1 and a tied head the served token is the input
# token by ~45 standard deviations, whatever the precision.
STD, NORM_STD, BIAS_STD = 0.02, 0.1, 0.1


def leaves(shape: Dict, n_layers: int, vocab_rows: int
           ) -> List[Tuple[str, Tuple[int, ...], float, float]]:
    """(name, shape, mean, spread) of every weight, drawn N(mean,
    spread^2).  Projections are (out, in), as ``nn.Linear`` keeps them."""
    d, H, K = shape["d_model"], shape["n_heads"], shape["n_kv_heads"]
    dh, f = shape["d_head"], shape["d_ff"]
    w, nrm, b = STD, NORM_STD, BIAS_STD
    out = [("embed", (vocab_rows, d), 0.0, w)]
    for i in range(n_layers):
        p = f"layers.{i}."
        out += [(p + "ln1", (d,), 1.0, nrm),
                (p + "wq", (H * dh, d), 0.0, w),
                (p + "wk", (K * dh, d), 0.0, w),
                (p + "wv", (K * dh, d), 0.0, w)]
        if shape["qkv_bias"]:
            out += [(p + "bq", (H * dh,), 0.0, b),
                    (p + "bk", (K * dh,), 0.0, b),
                    (p + "bv", (K * dh,), 0.0, b)]
        if shape["qk_norm"]:
            out += [(p + "q_norm", (dh,), 1.0, nrm),
                    (p + "k_norm", (dh,), 1.0, nrm)]
        out += [(p + "wo", (d, H * dh), 0.0, w),
                (p + "ln2", (d,), 1.0, nrm),
                (p + "w_gate", (f, d), 0.0, w),
                (p + "w_up", (f, d), 0.0, w),
                (p + "w_down", (d, f), 0.0, w)]
    out.append(("final_norm", (d,), 1.0, nrm))
    if not shape["tie_embeddings"]:
        out.append(("lm_head", (vocab_rows, d), 0.0, w))
    return out


def port_state(w: Dict[str, torch.Tensor], n_layers: int, shape: Dict
               ) -> Dict[str, torch.Tensor]:
    """The same tensors under the port's parameter names
    (``repro_torch.models.transformer.LM``)."""
    sd = {"embed": w["embed"], "final_norm.scale": w["final_norm"]}
    if "lm_head" in w:
        sd["lm_head.weight"] = w["lm_head"]
    for i in range(n_layers):
        p = f"layers.{i}."
        sd[p + "ln1.scale"] = w[p + "ln1"]
        sd[p + "ln2.scale"] = w[p + "ln2"]
        for a in ("q", "k", "v"):
            sd[p + f"attn.w{a}.weight"] = w[p + f"w{a}"]
            if shape["qkv_bias"]:
                sd[p + f"attn.w{a}.bias"] = w[p + f"b{a}"]
        if shape["qk_norm"]:
            sd[p + "attn.q_norm.scale"] = w[p + "q_norm"]
            sd[p + "attn.k_norm.scale"] = w[p + "k_norm"]
        sd[p + "attn.wo.weight"] = w[p + "wo"]
        sd[p + "mlp.wi_gate.weight"] = w[p + "w_gate"]
        sd[p + "mlp.wi_up.weight"] = w[p + "w_up"]
        sd[p + "mlp.wo.weight"] = w[p + "w_down"]
    return sd


def proj_flops(model: Dict, n_layers: int) -> float:
    """FLOPs of one token through the projections and the MLP."""
    d, H, K = model["d_model"], model["n_heads"], model["n_kv_heads"]
    dh, f = model["d_head"], model["d_ff"]
    per_layer = d * H * dh + 2 * d * K * dh + H * dh * d + 3 * d * f
    return 2.0 * per_layer * n_layers
