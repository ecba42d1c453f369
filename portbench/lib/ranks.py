"""The ranks of a multi-process deployment, driven from the one process the
harness calls an entry in.

That process is rank 0.  :class:`Ranks` starts the other ranks as worker
processes (``multiprocessing``, spawn: :func:`serve`), and every rank joins
one ``torch.distributed`` group at tcp://127.0.0.1:<free port>: nccl on
the cards, rank r on ``cuda:r`` with ``device_id`` set (so the sharded
tier's device tensors take its direct route), gloo on the CPU.  Each call's
inputs travel to every worker as one pickled object through a pipe, as a
deployment's driver hands each rank the list; each worker runs the same
call and sends back a digest of its answer (:func:`digest`).

Every wait is bounded.  The group's ``timeout`` bounds each collective and
the rendezvous; the wait for a worker's reply ends when the worker dies or
at the same deadline.  A lost worker raises :class:`RanksLost`.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
import socket
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait
from typing import List, Optional, Tuple

import numpy as np

#: seconds: the process group's timeout, and the deadline of every wait for
#: a worker
TIMEOUT_S = 300.0
#: seconds a stopped worker gets to leave before it is killed
STOP_S = 30.0


class RanksLost(BaseException):
    """A worker rank died or did not answer within its deadline: the group
    cannot go on.  Not an ``Exception``: the harness counts a call that
    raises an ``Exception`` and calls again, and a group that lost a rank
    has to end the run instead."""


def digest(frame) -> str:
    """A hash of a self-join answer's ``left_index``, ``right_index`` and
    ``similarity`` columns, in their order."""
    h = hashlib.sha256()
    for col, dtype in (("left_index", np.int64), ("right_index", np.int64),
                       ("similarity", np.float64)):
        h.update(np.ascontiguousarray(frame[col].to_numpy(dtype=dtype)).tobytes())
    return h.hexdigest()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, port: int, device: str, timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    kwargs = {}
    backend = "gloo"
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
        backend = "nccl"
        kwargs["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s),
                            **kwargs)


def serve(rank: int, world: int, port: int, device: str, timeout_s: float, conn) -> None:
    """A worker rank: join the group, then for each call message run
    ``StringGrouper(series, device=device, **options).fit().get_matches()``
    and send back ``("ok", digest)`` or ``("error", traceback)``, until a
    stop message or the pipe's end."""
    import torch.distributed as dist

    import string_grouper_tpu_torch as sgt

    _join(rank, world, port, device, timeout_s)
    try:
        conn.send(("ready", rank))
        while True:
            try:
                msg = pickle.loads(conn.recv_bytes())
            except EOFError:  # rank 0 is gone
                return
            if msg[0] == "stop":
                return
            _, series, options = msg
            try:
                frame = sgt.StringGrouper(series, device=device, **options).fit().get_matches()
                reply = ("ok", digest(frame))
                del frame
            except Exception:  # reported to rank 0, which fails the call
                reply = ("error", traceback.format_exc())
            conn.send(reply)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Ranks 1 .. world - 1 as worker processes beside this one, rank 0.

    ``device_type`` "cuda" puts rank r on ``cuda:r`` under nccl, "cpu"
    every rank on the CPU under gloo.  ``timeout_s`` defaults to
    ``TIMEOUT_S``.  ``target`` is the workers' function (:func:`serve`; an
    importable function of the same arguments)."""

    def __init__(self, world: int, device_type: str,
                 timeout_s: Optional[float] = None, target=serve):
        import torch.distributed as dist

        if world < 2:
            raise ValueError(f"a deployment of ranks needs at least 2, got {world}")
        if dist.is_initialized():
            raise RuntimeError("this process is already in a torch.distributed group")
        self.timeout_s = float(TIMEOUT_S if timeout_s is None else timeout_s)
        self.devices = [f"cuda:{r}" if device_type == "cuda" else "cpu"
                        for r in range(world)]
        self.device = self.devices[0]
        self.closed = False
        self.pending = False
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")
        port = _free_port()
        ctx = multiprocessing.get_context("spawn")
        self.conns, self.procs = [], []
        try:
            for r in range(1, world):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(target=target, name=f"rank-{r}", daemon=True,
                                   args=(r, world, port, self.devices[r], self.timeout_s,
                                         theirs))
                proc.start()
                theirs.close()
                self.conns.append(mine)
                self.procs.append(proc)
            _join(0, world, port, self.device, self.timeout_s)
            for r, got in enumerate(self._collect(), 1):
                if got != ("ready", r):
                    raise RanksLost(f"rank {r} answered {got!r} to the join")
        except BaseException:
            self.close()
            raise

    def _collect(self) -> List[Tuple]:
        """One message from every worker, each within the deadline."""
        out = []
        deadline = time.monotonic() + self.timeout_s
        for r, (conn, proc) in enumerate(zip(self.conns, self.procs), 1):
            while not conn.poll():
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RanksLost(f"rank {r} sent nothing within {self.timeout_s:.0f} s")
                if proc.sentinel in wait([conn, proc.sentinel], timeout=left) \
                        and not conn.poll():
                    raise RanksLost(f"rank {r} ended with exit code {proc.exitcode}")
            try:
                out.append(conn.recv())
            except (EOFError, OSError) as e:
                raise RanksLost(f"rank {r}: {e!r}") from e
        return out

    def handoff(self, series, options: dict) -> float:
        """Send one call's inputs to every worker, as one pickled object;
        returns the seconds it took.  A previous call's replies that were
        not read are drained first."""
        if self.closed:
            raise RanksLost("the ranks were stopped")
        if self.pending:
            self.replies()
        t0 = time.perf_counter()
        blob = pickle.dumps(("call", series, options), protocol=pickle.HIGHEST_PROTOCOL)
        for r, conn in enumerate(self.conns, 1):
            try:
                conn.send_bytes(blob)
            except OSError as e:
                raise RanksLost(f"rank {r} took no input: {e!r}") from e
        self.pending = True
        return time.perf_counter() - t0

    def replies(self) -> List[Tuple[str, str]]:
        """Every worker's reply to the last call: ``("ok", digest)`` or
        ``("error", traceback)``."""
        self.pending = False
        return self._collect()

    def close(self) -> None:
        """Stop the workers (a stop message; killed after ``STOP_S``) and
        leave the group.  Safe to call twice."""
        import torch.distributed as dist

        if self.closed:
            return
        self.closed = True
        stop = pickle.dumps(("stop",))
        for conn in self.conns:
            try:
                conn.send_bytes(stop)
            except OSError:
                pass
        deadline = time.monotonic() + STOP_S
        for proc in self.procs:
            proc.join(max(deadline - time.monotonic(), 0.1))
            if proc.is_alive():
                proc.kill()
                proc.join(STOP_S)
        for conn in self.conns:
            conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()
