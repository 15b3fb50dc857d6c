"""Checkpoints of the port's training state, in the reference's layout:
the round trip, the LATEST pointer and garbage collection, crash
atomicity, restores across the two packages in both directions (the
reference's ``train/checkpoint.py`` reading what the port wrote, and the
port reading what the reference wrote, parameters and Adam moments
alike), and the launcher: ``repro_torch.launch.train --device cpu`` run
to a simulated crash and resumed ends bit-equal to an uninterrupted run.

Tolerance: exact (every value is copied, or computed in the same order
on the same machine)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as get_smoke_config_j
from repro.models import registry as RJ
from repro.train import checkpoint as CKJ
from repro.train import data as DJ
from repro.train import optimizer as OJ
from repro.train import train_loop as TLJ
from repro.train.checkpoint import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as LT
from repro_torch.models import bridge
from repro_torch.models import registry as RT
from repro_torch.train import checkpoint as CKT
from repro_torch.train import data as DT
from repro_torch.train import optimizer as OT
from repro_torch.train import train_loop as TLT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Run this file's small tensor ops on one thread: beside the other
    test workers, a pool of a thread a core makes every op wait for
    threads that have no core (a tiny train step took 577 ms at 8 threads
    beside 7 busy processes, 26 ms at 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
            d_ff=64, vocab_size=64)


def _cfg():
    return get_smoke_config("qwen2-0.5b").with_(dtype=torch.float32, **TINY)


def _trained_state(seed=0, steps=2):
    """A port train state after ``steps`` steps (nonzero moments)."""
    cfg = _cfg()
    opt = OT.AdamWConfig(lr=1e-3)
    state = TLT.make_train_state(RT.init_params(cfg, seed=seed,
                                                device="cpu"), opt)
    step = TLT.make_train_step(cfg, opt)
    ds = DT.SyntheticLM(DT.DataConfig(cfg.vocab_size, 16, 4))
    for i in range(steps):
        state, _ = step(state, DT.to_device(ds.batch_at(i), "cpu"))
    return state


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_checkpoint_round_trip(tmp_path):
    state = _trained_state()
    d = str(tmp_path / "ckpt")
    CKT.save(state, 7, d)
    assert CKT.latest_step(d) == 7
    fresh = TLT.make_train_state(RT.init_params(_cfg(), seed=5,
                                                device="cpu"),
                                 OT.AdamWConfig())
    restored = CKT.restore(d, fresh)
    assert restored is fresh
    _equal(CKT._flatten(restored), CKT._flatten(state))
    assert int(restored["opt"]["step"]) == 2
    with pytest.raises(FileNotFoundError):
        CKT.restore(str(tmp_path / "empty"), fresh)


def test_checkpoint_latest_pointer_and_gc(tmp_path):
    state = {"params": RT.init_params(_cfg(), seed=0, device="cpu")}
    d = str(tmp_path / "ckpt")
    ck = CKT.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ck.submit(state, s)
        ck.wait()
    ck.close()
    assert CKT.latest_step(d) == 3
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000002", "step_00000003"]      # GC kept 2


def test_checkpoint_crash_atomicity(tmp_path):
    """A stray temporary directory of a crashed save never becomes the
    restore point, and the last complete checkpoint restores."""
    state = _trained_state(steps=1)
    d = str(tmp_path / "ckpt")
    CKT.save(state, 1, d)
    os.makedirs(os.path.join(d, ".tmp_ckpt_crashed"), exist_ok=True)
    assert CKT.latest_step(d) == 1
    fresh = _trained_state(seed=3, steps=0)
    _equal(CKT._flatten(CKT.restore(d, fresh)), CKT._flatten(state))


def _ref_state(cfg_j, steps):
    opt = OJ.AdamWConfig(lr=1e-3)
    state = TLJ.make_train_state(RJ.init_params(jax.random.PRNGKey(0),
                                                cfg_j), opt)
    step = jax.jit(TLJ.make_train_step(cfg_j, opt))
    ds = DJ.SyntheticLM(DJ.DataConfig(cfg_j.vocab_size, 16, 4))
    for i in range(steps):
        state, _ = step(state, {k: jnp.asarray(v)
                                for k, v in ds.batch_at(i).items()})
    return state


def test_port_checkpoint_restores_in_reference(tmp_path):
    """What the port writes, the reference's ``restore`` reads into its own
    train state's structure, every array equal: keys, shapes, dtypes and
    the stacked / transposed layout."""
    cfg_j = get_smoke_config_j("qwen2-0.5b").with_(dtype=jnp.float32, **TINY)
    state = _trained_state()
    d = str(tmp_path / "ckpt")
    CKT.save(state, 2, d)
    target = jax.eval_shape(lambda: _ref_state(cfg_j, 0))
    restored = CKJ.restore(d, target)
    _equal(_flatten(restored), CKT._flatten(state))


def test_reference_checkpoint_restores_in_port(tmp_path):
    """What the reference writes after two steps, the port restores into
    its train state: parameters and both moments, mapped through the
    bridge, and the step counter."""
    cfg_j = get_smoke_config_j("qwen2-0.5b").with_(dtype=jnp.float32, **TINY)
    s_j = _ref_state(cfg_j, 2)
    d = str(tmp_path / "ckpt")
    CKJ.save(s_j, 2, d)
    state = TLT.make_train_state(RT.init_params(_cfg(), seed=9,
                                                device="cpu"),
                                 OT.AdamWConfig())
    CKT.restore(d, state)
    _equal(CKT._flatten(state), _flatten(s_j))
    assert state["params"].embed.requires_grad


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    """``launch.train`` on the CPU: a run that crashes at step 3 (its
    checkpoint durable) and is resumed ends with the same step-6
    checkpoint, bit for bit, as a run of 6 steps without a crash; the
    reference's ``[train]`` lines are printed."""
    common = ["--arch", "qwen2-0.5b", "--steps", "6", "--batch", "2",
              "--seq", "16", "--ckpt-every", "2", "--scale", "0.5",
              "--device", "cpu"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert LT.main(common + ["--ckpt-dir", a]) == 0
    assert LT.main(common + ["--ckpt-dir", b, "--simulate-crash-at",
                             "3"]) == 0
    assert CKT.latest_step(b) == 3
    assert LT.main(common + ["--ckpt-dir", b, "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[train] simulated crash at step 3" in out
    assert "[train] resumed from step 3" in out
    assert out.count("[train] done: final loss") == 2
    assert CKT.latest_step(a) == CKT.latest_step(b) == 6
    load = lambda d: dict(np.load(os.path.join(d, "step_00000006",
                                               "arrays.npz")))
    _equal(load(a), load(b))
    assert sorted(x for x in os.listdir(b) if x.startswith("step_")) == \
        ["step_00000003", "step_00000004", "step_00000006"]
