"""No JAX on the chip path: the whole-name check, and what the harness
and the port's serving path load."""
import os
import pathlib
import subprocess
import sys

import pytest

from clover_bench import guard

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_names_compared_whole():
    names = ["repro_torch", "repro_torch.serving.engine", "reprox", "json",
             "repro", "repro.models.layers", "jax", "jax.numpy", "jaxlib",
             "flax.linen"]
    assert guard.forbidden_loaded(names) == sorted(
        ["repro", "repro.models.layers", "jax", "jax.numpy", "jaxlib",
         "flax.linen"])


def _python(code, *args):
    env = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}")
    return subprocess.run([sys.executable, *args] if not code
                          else [sys.executable, "-c", code],
                          capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=240)


def test_harness_and_serving_path_load_no_jax():
    p = _python(
        "import clover_bench.harness, clover_bench.run, clover_bench.check,"
        " clover_bench.energy, clover_bench.trace, clover_bench.control,"
        " clover_bench.sweep\n"
        "import repro_torch.serving.engine, repro_torch.models.registry\n"
        "from repro_torch.serving.quality import StaticPinSelector\n"
        "from repro_torch.core.config_graph import ConfigGraph\n"
        "from clover_bench.guard import forbidden_loaded\n"
        "print(forbidden_loaded())")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = _python(None, "clover_bench/run.py", "--workload",
                "qwen3-1.7b.reasoning", "--seed", str(2**31 + 5),
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
