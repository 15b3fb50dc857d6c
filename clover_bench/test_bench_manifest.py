"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and bounds, the files each entry names, and what each cell
reports."""
import json
import math
import re

import pytest
import torch

from clover_bench import harness
from clover_bench import weights as W

ROOT = harness.ROOT
RAW = (ROOT / "BENCHMARK.json").read_text()
M = json.loads(RAW)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(RAW.encode()) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(M["command"]) <= 32
    assert M["command"][1].split("/")[0] in M["paths"]


def test_run_seconds_fits_the_check_with_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://")
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    for c in M["configs"] + M["workloads"]:
        assert "\n" not in c["why"] and "\t" not in c["why"]


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def _reports(metric, cell):
    return cell in metric.get("workloads", [w["name"]
                                            for w in M["workloads"]])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_what_it_must(cell):
    e2e = [m for m in M["end_to_end"] if _reports(m, cell)]
    pl = [m for m in M["per_layer"] if _reports(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert pl
    for m in pl:
        moved = {x["name"]: x for x in M["end_to_end"]}[m["moves"]]
        assert _reports(moved, cell), (m["name"], cell)


def test_per_layer_entries():
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        assert harness.reader_path(m["name"]).is_file()


def test_every_file_a_cell_needs_is_there():
    configs = {c["name"]: c for c in M["configs"]}
    for w in M["workloads"]:
        cfg = configs[w["config"]]
        assert cfg["file"].startswith(M["paths"][0] + "/")
        assert (ROOT / cfg["file"]).is_file()
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
        body = json.load(open(ROOT / cfg["file"]))
        assert body["reduced"] == cfg["reduced"]
        fam = body["model"]["family"]
        assert (harness.HERE / "reference" / f"{fam}.py").is_file()
        assert (harness.HERE / "families" / f"{fam}.py").is_file()
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_cells_fill_the_card_and_fit_it():
    """Each deployment's arenas and bf16 weights, from its own numbers,
    within the card's 80 GB and above half of it."""
    configs = {c["name"]: c for c in M["configs"]}
    for w in M["workloads"]:
        body = json.load(open(ROOT / configs[w["config"]]["file"]))
        mix = json.load(open(harness.HERE / "traffic"
                             / f"{w['traffic']}.json"))
        dep, m = mix["engine"], body["model"]
        total = 0.0
        for rung, n in dep["graph"].items():
            layers = max(int(m["n_layers"] * body["ladder"][rung]), 1)
            block = layers * dep["block_size"] * m["n_kv_heads"] * \
                m["d_head"] * 4 * 2
            params = sum(int(torch.Size(s).numel()) for _, s, _, _ in
                         W.family(m["family"]).leaves(m, layers,
                                                      m["vocab_size"]))
            total += n * (dep["n_blocks"] * block + 2 * params)
        assert 0.5 * 80e9 < total < 80e9, (w["name"], total)
        assert dep["n_blocks"] - 1 >= dep["max_seqs"] * math.ceil(
            dep["max_len"] / dep["block_size"]) or dep["prefix_caching"]


@pytest.mark.parametrize("config", [c["name"] for c in M["configs"]])
def test_a_configs_model_builds_the_ports_config_by_keyword(config):
    from repro_torch.models.config import ModelConfig
    entry = {c["name"]: c for c in M["configs"]}[config]
    body = json.load(open(ROOT / entry["file"]))
    cfg = ModelConfig(name=body["name"], dtype=getattr(torch, body["dtype"]),
                      **body["model"])
    assert cfg.family == body["model"]["family"]
    assert getattr(torch, body["kv_dtype"]).is_floating_point
