"""The PyTorch port stands alone: importing it and every submodule pulls in
no JAX, no file of the port (nor ``chip_smoke.py``) names the reference
package, and an entry point given no device runs on the GPU or raises —
never quietly on the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_every_port_module_leaves_jax_out():
    mods = list(_port_modules())
    for mod in ("repro_torch.serving.engine",
                "repro_torch.kernels.decode_attention",
                "repro_torch.launch.serve", "repro_torch.core.annealing",
                "repro_torch.core.carbon", "repro_torch.core.objective",
                "repro_torch.configs", "repro_torch.fleet.fleet_sim",
                "repro_torch.serving.simulator",
                "repro_torch.serving.backends",
                "repro_torch.core.controller", "repro_torch.obs.aggregate",
                "repro_torch.configs.gemma3_27b",
                "repro_torch.configs.glm4_9b",
                "repro_torch.configs.qwen2_0_5b",
                "repro_torch.serving.disagg", "repro_torch.serving.queue",
                "repro_torch.obs.export", "repro_torch.obs.slo",
                "repro_torch.obs.validate", "repro_torch.models.encdec",
                "repro_torch.configs.seamless_m4t_large_v2",
                "repro_torch.configs.qwen2_vl_7b", "repro_torch.train",
                "repro_torch.train.data", "repro_torch.train.optimizer",
                "repro_torch.train.compression",
                "repro_torch.train.train_loop",
                "repro_torch.train.checkpoint", "repro_torch.launch.train",
                "repro_torch.sharding", "repro_torch.sharding.rules",
                "repro_torch.launch.mesh", "repro_torch.launch.steps",
                "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
                "repro_torch.configs.shapes", "repro_torch.launch.ranks",
                "repro_torch.sharding.collectives",
                "repro_torch.train.parallel"):
        assert mod in mods
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_port_file_names_no_reference_module(path):
    text = (ROOT / path).read_text()
    assert not re.search(r"\brepro\.", text), path
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path


def test_entry_point_without_device_uses_gpu_or_raises():
    from repro_torch import resolve_device
    from repro_torch.configs import qwen3_1_7b
    from repro_torch.models import registry as R
    from repro_torch.serving import engine as ENG
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.init_params(qwen3_1_7b.SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENG.build_engine_family(qwen3_1_7b.SMOKE, fracs=(1.0,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.make_block_arena(qwen3_1_7b.SMOKE, 4, 8)
    from repro_torch.launch import ranks
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ranks.spawn(print, 2)
    assert resolve_device("cpu") == torch.device("cpu")
