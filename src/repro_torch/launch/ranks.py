"""Ranks of a process group on one host — how a mesh of several devices
runs (``launch/mesh.py``): one process a device, each holding its shard
of every tensor, the collectives explicit (``sharding/collectives.py``).

:func:`spawn` starts ``world`` ranks, runs ``fn(args, *extra)`` on each
with a :class:`RankArgs`, and returns every rank's result in rank order.
Under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` set) this
process is one rank and runs ``fn`` itself.  The backend is chosen by
rule, never by trying one and catching its error (:func:`backend_for`):
NCCL when each rank owns a GPU, gloo when ranks share one or run on the
CPU.  A rank's exception is raised in the caller — the first one to
arrive, with the rank's traceback — and the other ranks are stopped: a
rank that fails never lets the others carry on, and a rank waiting in a
collective for a rank that died is not waited for.  Every spawn runs
under a timeout, since ranks whose schedulers drift apart hang in a
collective rather than fail.

The kernels are built in the caller before the ranks start, so two ranks
never build them at once (``kernels/_build.py``).  ``fn`` and its
arguments reach each rank through a queue once every rank has started:
the spawn start method writes a process's arguments into a pipe that
its child reads only once its interpreter is up, so large arguments
handed to ``Process`` itself would start the ranks one after another.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["RankArgs", "backend_for", "spawn"]


@dataclasses.dataclass(frozen=True)
class RankArgs:
    """What a rank knows of itself: its rank and local rank, the world
    size, the backend and the device kind ("cuda" or "cpu")."""
    rank: int
    world_size: int
    local_rank: int
    backend: str
    device_type: str

    @property
    def device(self) -> torch.device:
        """``cuda:{local_rank % device_count}``, or the CPU."""
        if self.device_type == "cuda":
            return torch.device("cuda",
                                self.local_rank % torch.cuda.device_count())
        return torch.device(self.device_type)


def backend_for(world: int, device_type: str,
                n_gpus: Optional[int] = None) -> str:
    """NCCL when each of the host's ``world`` ranks owns a GPU; gloo when
    ranks share one (NCCL puts no two ranks on one device) or run on the
    CPU."""
    if device_type != "cuda":
        return "gloo"
    n = torch.cuda.device_count() if n_gpus is None else n_gpus
    return "nccl" if world <= n else "gloo"


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the ranks on the CPU")
        return "cuda"
    return torch.device(device).type


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(args: RankArgs, init_method: str, timeout: float) -> None:
    if args.device_type == "cuda":
        torch.cuda.set_device(args.device)
    dist.init_process_group(args.backend, init_method=init_method,
                            rank=args.rank, world_size=args.world_size,
                            timeout=timedelta(seconds=timeout))


def _rank_main(inbox, args: RankArgs, init_method: str,
               timeout: float, results) -> None:
    """One spawned rank: take ``(fn, extra)`` from ``inbox``, join the
    group, run ``fn``, report (rank, ok, result or (exception, traceback
    text))."""
    os.environ.update(RANK=str(args.rank), LOCAL_RANK=str(args.local_rank),
                      WORLD_SIZE=str(args.world_size))
    try:
        fn, extra = inbox.get()
        _init(args, init_method, timeout)
        out = fn(args, *extra)
        results.put((args.rank, True, out))
    except BaseException as e:          # reported, then re-raised by spawn
        text = traceback.format_exc()
        try:
            results.put((args.rank, False, (e, text)))
        except Exception:               # an exception that does not pickle
            results.put((args.rank, False, (None, text)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _torchrun(fn, world: int, device_type: str, extra, timeout: float
              ) -> List[Any]:
    rank = int(os.environ["RANK"])
    size = int(os.environ["WORLD_SIZE"])
    if size != world:
        raise ValueError(f"spawn of {world} ranks under torchrun's "
                         f"WORLD_SIZE={size}")
    local = int(os.environ.get("LOCAL_RANK", rank))
    args = RankArgs(rank, size, local,
                    backend_for(int(os.environ.get("LOCAL_WORLD_SIZE",
                                                   size)), device_type),
                    device_type)
    if device_type == "cuda":
        from repro_torch.kernels import _build
        _build.extension()
    _init(args, "env://", timeout)
    try:
        out: List[Any] = [None] * size
        out[rank] = fn(args, *extra)
        return out
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device=None, *, args: tuple = (),
          timeout: float = 300.0) -> List[Any]:
    """Run ``fn(RankArgs, *args)`` on ``world`` ranks of one process group
    on this host and return their results in rank order (``fn`` and its
    results must pickle: a module-level function).  ``device`` is the
    ranks' device kind — the GPUs by default, ``"cpu"`` on request.
    Raises the first rank's exception, and ``TimeoutError`` when the ranks
    have not all returned within ``timeout`` seconds; either way every
    rank is stopped.  Under torchrun this process is one rank: it runs
    ``fn`` and the list holds its own result only."""
    kind = _device_type(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
            and not dist.is_initialized():
        return _torchrun(fn, world, kind, args, timeout)
    if kind == "cuda":
        # built here, once, before any rank looks for it
        from repro_torch.kernels import _build
        _build.extension()
    backend = backend_for(world, kind)
    init = f"tcp://localhost:{_free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(inboxes[r], RankArgs(r, world, r, backend,
                                                    kind),
                               init, timeout, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    for q in inboxes:
        q.put((fn, args))
        # a rank that dies unread must not hold this process at its exit
        q.cancel_join_thread()
    out: List[Any] = [None] * world
    got = 0
    deadline = time.monotonic() + timeout
    try:
        while got < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world - got} of {world} ranks "
                                   f"did not return within {timeout:g} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {procs.index(dead[0])} died with exit "
                        f"code {dead[0].exitcode} before reporting")
                continue
            if not ok:
                exc, text = payload
                if exc is None:
                    exc = RuntimeError(f"rank {rank} failed")
                exc.add_note(f"in rank {rank} of {world}:\n{text}")
                raise exc
            out[rank] = payload
            got += 1
    finally:
        for p in procs:
            if p.is_alive() and got < world:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        for q in inboxes:
            q.close()
    return out
