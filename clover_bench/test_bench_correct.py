"""The comparison that decides ``correct``: the plain reference against
the port, whole runs of each cell cut to a CPU's size, the control in
lower precision, and the faults a run can have, each of which has to
read as not correct."""
import json
import time

import numpy as np
import pytest
import torch

from clover_bench import check, harness, tiny
from clover_bench import weights as W

CELLS = ("qwen3-1.7b.reasoning", "glm4-9b.rag", "qwen3-1.7b.clover-mix")
CPU = torch.device("cpu")


def _port(model, n_layers, dtype, w):
    from repro_torch.models import registry as R
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="t", dtype=dtype,
                      **dict(model, n_layers=n_layers))
    return cfg, W.bind(R.init_params(cfg, device="meta"), w, n_layers, model)


def _model(config, **width):
    m = dict(json.load(open(harness.HERE / "configs"
                            / f"{config}.json"))["model"])
    m.update(tiny.TINY_MODEL, **width)
    return m


@pytest.mark.parametrize("config", ["qwen3-1.7b", "glm4-9b"])
def test_reference_matches_the_port_in_f32(config):
    from repro_torch.models import registry as R
    m = _model(config)
    gen = torch.Generator().manual_seed(3)
    rows = ((m["vocab_size"] + 15) // 16) * 16
    w = W.make(m, 4, rows, gen, torch.float32, CPU)
    cfg, params = _port(m, 4, torch.float32, w)
    toks = torch.randint(0, m["vocab_size"], (96,), generator=gen)
    mine, _ = R.forward(params, {"tokens": toks[None]}, cfg)
    ref = check.reference_module("dense").logits(w, m, 4, toks, 0)
    err = (mine[0].float() - ref).abs().max() / ref.std()
    assert err < 2e-5, float(err)


@pytest.mark.parametrize("config", ["qwen3-1.7b", "glm4-9b"])
def test_the_control_in_fp8_separates_from_the_port(config):
    """The control at a width a test holds (d 512, 8 layers, 300 served
    positions): the tokens the reference in fp8 puts first lie more than
    four times as far below the f32 reference's best as the bf16 port's
    do, on each seed, and the port stays under every cell's limit.  At
    the cells' own sizes the control's gaps pass the limits (the
    readings in PERF.md, from ``control.py`` on the card); here they are
    smaller, since the error grows with width, depth and length."""
    from repro_torch.models import registry as R
    m = _model(config, n_layers=8, d_model=512, n_heads=8, d_head=64,
               d_ff=1536, vocab_size=8192)
    limits = [json.load(open(harness.HERE / "limits" / f"{c}.json"))
              ["gap_max"] for c in CELLS]
    ref = check.reference_module("dense")
    for seed in (0, 1):
        gen = torch.Generator().manual_seed(seed)
        rows = ((m["vocab_size"] + 15) // 16) * 16
        w = W.make(m, 8, rows, gen, torch.bfloat16, CPU)
        cfg, params = _port(m, 8, torch.bfloat16, w)
        toks = torch.randint(0, m["vocab_size"], (400,), generator=gen)
        lg = ref.logits(w, m, 8, toks, 100)
        ctrl = ref.logits(w, m, 8, toks, 100, quant="fp8").argmax(-1)
        mine, _ = R.forward(params, {"tokens": toks[None]}, cfg)
        port = float(check.gaps(lg, mine[0, 100:].float().argmax(-1)).max())
        assert port < min(limits)
        assert float(check.gaps(lg, ctrl).max()) > 4 * port


def _run(cell, seconds=3.0, seed=2**31 + 101):
    return harness.run(cell, seed, seconds, False, CPU, time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_at_a_cpus_size_runs_correct(name):
    res = _run(tiny.cell(name))
    assert res["correct"], res["numbers"]
    assert res["numbers"][0][1] < tiny.LIMIT / 3
    assert res["numbers"][0][0] == "gap_max"
    assert res["metrics"]["setup_s"]["value"] > 0
    assert res["attempted"] > 0 and res["failed"] == 0


def _fault_unchanged_state(R):
    """Steps that leave the arena as they found it: every prefill chunk
    and decode dispatch computes, then its K/V writes are undone."""
    pf, dm = R.prefill_paged, R.decode_paged_multi

    def keep(fn, arena):
        def call(*args):
            saved = {k: v.clone() for k, v in arena.items()}
            out = fn(*args)
            for k, v in saved.items():
                arena[k].copy_(v)
            return out
        return call

    def prefill(params, batch, arena, table, n_past, true_c):
        return keep(pf, arena)(params, batch, arena, table, n_past, true_c)

    def decode(params, arena, batch, tables, lengths, active, n):
        return keep(dm, arena)(params, arena, batch, tables, lengths,
                               active, n)
    return {"prefill_paged": prefill, "decode_paged_multi": decode}


def _fault_half_batch(R):
    """Half of the decode rows left out: their tokens are not computed
    (the rest's stand in)."""
    dm = R.decode_paged_multi

    def f(params, arena, batch, tables, lengths, active, n):
        b = active.shape[0]
        keep = active.clone()
        keep[b // 2:] = False
        toks, nxt, ln = dm(params, arena, batch, tables, lengths, keep, n)
        if b > 1:
            toks[:, b // 2:] = toks[:, :1]
        nxt = torch.where(active[:, None], toks[-1][:, None],
                          batch["tokens"])
        return toks, nxt, torch.where(active, lengths + n, lengths)
    return {"decode_paged_multi": f}


def _fault_token_altered(L):
    """The greedy pick of the first row altered where it is made (the
    layers' pick, which prefill and the fused decode both call)."""
    gt = L.greedy_token

    def f(logits, mesh=None):
        tok = gt(logits, mesh).clone()
        tok.view(-1)[0] = (tok.view(-1)[0] + 1) % logits.shape[-1]
        return tok
    return {"greedy_token": f}


@pytest.mark.parametrize("fault", [_fault_unchanged_state,
                                   _fault_half_batch, _fault_token_altered])
@pytest.mark.parametrize("name", ["qwen3-1.7b.reasoning", "glm4-9b.rag"])
def test_a_fault_reads_not_correct(fault, name, monkeypatch):
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    mod = L if fault is _fault_token_altered else R
    for attr, f in fault(mod).items():
        monkeypatch.setattr(mod, attr, f)
    res = _run(tiny.cell(name))
    assert not res["correct"], res["numbers"]


def test_the_engine_is_held_to_the_stated_kv_type():
    """A config whose ``kv_dtype`` is not the type of the engine's arena
    is refused at set-up, not measured with bytes counted wrong."""
    cell = tiny.cell("qwen3-1.7b.reasoning")
    cell.config["kv_dtype"] = "bfloat16"
    with pytest.raises(ValueError, match="kv_dtype"):
        harness.build(cell, 5, CPU)


def test_the_sample_holds_the_longest_of_each_rung():
    fin = [{"rid": i, "prompt": np.zeros(10 + i), "tokens": [1] * 5,
            "variant": v} for i, v in enumerate(["a", "b", "a", "b", "c"])]
    s = check.pick_sample(fin, 7, min_tokens=15, max_requests=10)
    assert [r["rid"] for r in s[:3]] == [4, 3, 2]
    assert sum(len(r["tokens"]) for r in s) == 15
