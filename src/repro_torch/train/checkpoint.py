"""Checkpoints in the reference's layout — the port's counterpart of the
reference package's ``train/checkpoint.py``: atomic writes, an
asynchronous save thread with garbage collection, and a restore that
reads checkpoints written by either package.

Layout: ``<dir>/step_<n>/arrays.npz`` + ``manifest.json``, and a top-level
``LATEST`` file, replaced last by a rename (atomic on POSIX), so a crash
mid-save never corrupts the restore point.  The arrays are keyed as the
reference flattens its train state: ``params/<key>``, ``opt/m/<key>``,
``opt/v/<key>`` and ``opt/step``, each ``<key>`` a leaf of the reference's
params (stacked layers, (in, out) dense weights); weights and Adam's
moments go through ``models/bridge.py``'s one map (``to_reference`` /
``from_reference``), so a checkpoint written here restores in the
reference and the reverse.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models import bridge

Arrays = Dict[str, np.ndarray]


def _flatten(state: dict) -> Arrays:
    """The train state ``{"params": model[, "opt": {"m", "v", "step"}]}``
    as the reference's flat arrays, on the host."""
    model = state["params"]
    out = {f"params/{k}": v
           for k, v in bridge.export_reference(model).items()}
    opt = state.get("opt")
    if opt is not None:
        for part in ("m", "v"):
            out.update({f"opt/{part}/{k}": v for k, v in
                        bridge.to_reference(model, opt[part]).items()})
        out["opt/step"] = np.asarray(opt["step"].cpu().numpy(), np.int32)
    return out


def _write(arrays: Arrays, step: int, ckpt_dir: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # the LATEST pointer: write a temporary file, then rename it
    latest_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(f"step_{step:08d}")
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def save(state: dict, step: int, ckpt_dir: str) -> str:
    """Synchronous atomic save.  Returns the step directory."""
    return _write(_flatten(state), step, ckpt_dir)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip().split("_")[1])


@torch.no_grad()
def restore(ckpt_dir: str, state: dict, step: Optional[int] = None) -> dict:
    """Read the checkpoint at ``step`` (the LATEST one by default) into
    ``state`` — its model's parameters (cast to their type, on their
    device) and, when the state has one, the optimizer state — in place.
    Returns ``state``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    model = state["params"]

    def part(prefix: str) -> Dict[str, torch.Tensor]:
        n = len(prefix)
        return bridge.from_reference(model, {k[n:]: v for k, v in
                                             arrays.items()
                                             if k.startswith(prefix)})

    params = dict(model.named_parameters())
    for name, src in part("params/").items():
        params[name].copy_(src.to(dtype=params[name].dtype,
                                  device=params[name].device))
    opt = state.get("opt")
    if opt is not None:
        for key in ("m", "v"):
            opt[key] = {name: src.to(dtype=torch.float32,
                                     device=params[name].device)
                        for name, src in part(f"opt/{key}/").items()}
        opt["step"] = torch.as_tensor(
            arrays["opt/step"].astype(np.int32),
            device=opt["step"].device)
    return state


class AsyncCheckpointer:
    """Background save thread: the train loop hands off host copies and
    keeps stepping; ``wait()`` drains before exit.  One save in flight at a
    time (a second submit blocks) — bounded memory, no checkpoint dropped.
    After each save only the newest ``keep`` step directories remain."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            arrays, step = item
            try:
                _write(arrays, step, self.ckpt_dir)
                self._gc()
            except BaseException as e:  # surfaced on the next submit / wait
                self._err = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)

    def submit(self, state: dict, step: int):
        if self._err:
            raise self._err
        self._q.put((_flatten(state), step))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()
