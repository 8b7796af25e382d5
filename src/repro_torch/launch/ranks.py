"""A world of N ranks for the launch layer's mesh programs: one process a
rank, spawned (``torch.multiprocessing`` with the spawn start method, as
``serving/multiproc/launcher.py`` starts its workers), each joined to a
``torch.distributed`` process group over a ``file://`` store in a
temporary directory, each on one device.

  with ranks.start(2) as world:                   # the card
      outs = world.run(fn, arg)                   # fn(rank, arg) on every rank
  with ranks.start(2, device="cpu") as world:     # the CPU, asked for
      ...

``fn`` is a module-level function (the spawn start method pickles it by
name), called as ``fn(rank, *args)`` with ``rank`` a ``Rank`` (its index,
the world's size, the backend, its device); what it returns comes back
to the parent through a queue, so it must pickle: CPU tensors and plain
values, not CUDA tensors. The CPU tensors of ``args`` reach every rank as
one shared-memory copy (``torch.multiprocessing`` moves their storage
there, the parent's included): a rank that updates one in place must
copy it first. A rank builds its mesh with ``launch.mesh.make_mesh``
inside ``fn``.

The backend is chosen by one rule, stated and returned (``World.backend``):
``nccl`` when every rank has a card of its own (a CUDA world with at
least as many cards as ranks), ``gloo`` when ranks share a card or run on
the CPU (NCCL refuses two ranks of one communicator on one device). The
gloo ranks of a CUDA world all sit on card 0, and there
``models/collectives.py`` moves the collectives' tensors through the
card's memory, gloo carrying only the barriers. It is never a fallback:
if the chosen backend fails, the run fails.

A rank that raises ends the world: the parent kills every rank (the
others may wait in a collective for it) and raises ``RankError`` with the
rank's traceback. So does a rank that dies, and a call that outlasts
``timeout_s``. ``close`` (or leaving the ``with`` block) stops the ranks
and removes the store; no rank outlives its world.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

import torch

from repro_torch import device as _dev

JOIN_S = 10.0            # a rank's grace to exit after close, then killed


class RankError(RuntimeError):
    """A rank raised, died or timed out; the world is gone."""


@dataclasses.dataclass(frozen=True)
class Rank:
    """What ``fn`` is told about the rank it runs on."""
    index: int
    size: int
    backend: Optional[str]     # None: a lone rank, outside a world
    device: torch.device


def choose_backend(size: int, device_type: str) -> str:
    """``nccl`` when each of ``size`` ranks has a card of its own, else
    ``gloo`` (ranks sharing a card, or on the CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= size:
        return "nccl"
    return "gloo"


def _rank_device(index: int, backend: str, device_type: str
                 ) -> torch.device:
    if device_type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", index if backend == "nccl" else 0)


def _rank_main(index: int, size: int, backend: str, device_type: str,
               store: str, timeout_s: float, inbox, outbox) -> None:
    """A rank's process: join the group, then run each task from
    ``inbox`` until None, posting (index, ok, result or traceback)."""
    import torch.distributed as tdist
    try:
        dev = _rank_device(index, backend, device_type)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        tdist.init_process_group(
            backend, init_method=f"file://{store}", world_size=size,
            rank=index, timeout=datetime.timedelta(seconds=timeout_s))
        rank = Rank(index, size, backend, dev)
    except BaseException:
        outbox.put((index, False, traceback.format_exc()))
        return
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args = task
            del task
            try:
                done = (True, fn(rank, *args))
            except BaseException:
                done = (False, traceback.format_exc())
            # the call's arguments go before the next task arrives: CUDA
            # tensors the parent shared stay allocated while a rank holds
            # them
            del fn, args
            outbox.put((index,) + done)
            if not done[0]:
                break                  # the others are out of step now
    finally:
        tdist.destroy_process_group()


class World:
    """The ranks of one world (``start``)."""

    def __init__(self, size: int, device: _dev.DeviceLike = None,
                 timeout_s: float = 3600.0):
        import torch.multiprocessing as tmp
        dev = _dev.resolve(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"a world of ranks on {dev}")
        self.size = size
        self.device_type = dev.type
        self.backend = choose_backend(size, dev.type)
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="ranks_")
        ctx = tmp.get_context("spawn")
        self._out = ctx.Queue()
        self._ins = [ctx.Queue() for _ in range(size)]
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(i, size, self.backend, dev.type,
                  os.path.join(self._dir, "store"), timeout_s,
                  self._ins[i], self._out))
            for i in range(size)]
        for p in self._procs:
            p.start()

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def run(self, fn: Callable, *args: Any) -> List[Any]:
        """``fn(rank, *args)`` on every rank; returns their results in rank
        order. A rank that raises or dies, or a call past ``timeout_s``,
        kills the world and raises ``RankError``."""
        if not self._procs:
            raise RankError("the world is closed")
        for q in self._ins:
            q.put((fn, args))
        out: List[Any] = [None] * self.size
        pending = set(range(self.size))
        deadline = time.monotonic() + self.timeout_s
        while pending:
            try:
                index, ok, value = self._out.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i in pending
                        if not self._procs[i].is_alive()]
                if dead or time.monotonic() > deadline:
                    what = (f"rank {dead[0]} died (exit code "
                            f"{self._procs[dead[0]].exitcode})" if dead else
                            f"ranks {sorted(pending)} still running after "
                            f"{self.timeout_s} s; the world was killed")
                    self.kill()
                    raise RankError(what)
                continue
            if not ok:
                self.kill()
                raise RankError(f"rank {index} raised:\n{value}")
            out[index] = value
            pending.discard(index)
        return out

    def kill(self) -> None:
        """Stop every rank now (terminate, then kill) and drop the store."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def close(self) -> None:
        """Let every rank leave its group and exit; kill what does not."""
        if not self._procs:
            return
        for q in self._ins:
            q.put(None)
        for p in self._procs:
            p.join(JOIN_S)
        self.kill()

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start(size: int, device: _dev.DeviceLike = None,
          timeout_s: float = 3600.0) -> World:
    """A world of ``size`` ranks on the card (unless ``device="cpu"``)."""
    return World(size, device, timeout_s)

