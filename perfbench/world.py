"""A cell's world of ranks, one a card, for a configuration that names a
``backend``: rank 0 is the process that runs the cell (it times, traces,
checks and prints); ranks 1 … k − 1 are spawned processes that make every
call on the program that rank 0 makes, in the same order.

Rank 0 drives them over pipes, never over the program's own process
group, so that a follower idles on its pipe, not inside a collective,
while rank 0 runs the reference check.  Each command is answered by every
follower before rank 0 goes on; a call's answers are read once rank 0's
own call has returned:

* ``build max_outer`` — build the program's runtime for ``max_outer``;
* ``inputs index`` — draw solve ``index``'s inputs on the card and
  synchronise it (its peak memory reset first); the calls after run on
  them;
* ``call max_outer`` — call that runtime; the answer is the card's peak
  bytes since ``inputs``;
* ``trace`` / ``untrace`` — open the profiler (``profile.tracing``) /
  close it; the answer is its readings of this rank's card over this
  rank's own outer spans (no ``breakdown``).  While it is open, each call
  runs in a ``profile.window`` of its own, so that what rank 0 does
  around the calls, such as starting its profiler and reading its trace,
  lies outside this rank's windows;
* ``free`` — drop every runtime and the inputs;
* ``stop`` — the answer is the forbidden modules loaded; then exit.

The ranks meet at a ``FileStore`` in a temporary directory (no fixed
port) and join through ``launch.mesh.make_shard_group``; rank r runs on
``cuda:r``, or on the CPU.  A follower that raises prints its traceback
and sends it, and rank 0 raises it: at its next wait on the followers, or
at once where its own call fails because the peer left.  A follower that
exits, or does not answer within ``ANSWER_S``, ends the run too.  Where one
exits while rank 0 is held where nothing returns (joining the group, or a
collective that waits for the dead peer, as NCCL's does), rank 0's process
ends itself after ``GRACE_S`` with a non-zero code.  A follower dies with
rank 0's process, and ``close`` stops and joins every follower."""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import wait
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from perfbench import profile, spec
from perfbench.traffic import Mix

#: modules that must not be loaded in a run, by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the longest rank 0 waits for the followers' answers to one command,
#: once its own part of the command is done
ANSWER_S = 300.0
#: how long rank 0 may stay where nothing returns after a follower exited
GRACE_S = 30.0


def forbidden_loaded() -> List[str]:
    """The ``FORBIDDEN`` modules this process has loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def ranks(cell: spec.Cell) -> int:
    """The ranks of ``cell``'s world, one shard a rank: its chips where its
    configuration names a ``backend``; 0 where it runs stacked on one
    card."""
    if "backend" not in cell.config:
        if cell.chips != 1:
            raise ValueError(f"{cell.name}: a cell on {cell.chips} chips needs a "
                             "configuration that names a backend")
        return 0
    if int(cell.config["shards"]) != cell.chips:
        raise ValueError(f"{cell.name}: a world runs one shard a chip, but its "
                         f"configuration has {cell.config['shards']} shards on "
                         f"{cell.chips} chips")
    return cell.chips


@contextlib.contextmanager
def planted(plant: Optional[Callable]):
    """Run ``plant(patch)``, where ``patch(obj, name, value)`` sets an
    attribute, and set every patched attribute back on the way out."""
    undo = []

    def patch(obj, name: str, value) -> None:
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    try:
        if plant is not None:
            plant(patch)
        yield
    finally:
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)


@dataclass
class Job:
    """What every rank needs to set up the cell's program (picklable)."""

    cell: spec.Cell
    root: Path
    seed: int
    control: Optional[torch.dtype]
    plant: Optional[Callable]
    device_type: str
    threads: int

    def device(self, rank: int) -> torch.device:
        return torch.device("cpu") if self.device_type == "cpu" else torch.device("cuda", rank)

    def problem(self, device: torch.device, group=None):
        """(the family's problem on ``device``, the inputs the program runs:
        drawn from the seed, cast to the control's precision where there is
        one)."""
        prob = spec.family(self.cell, self.root).Problem(
            self.cell.config, Mix.read(self.cell.traffic), self.seed, device, group=group)
        if self.control is None:
            return prob, prob.inputs
        return prob, lambda i: tuple(t.to(self.control) for t in prob.inputs(i))

    def join(self, rank: int, path: str):
        """This rank's ``ShardGroup`` of the world."""
        from repro_torch.launch.mesh import make_shard_group

        backend, k = self.cell.config["backend"], self.cell.chips
        if backend == "gloo":   # a local world talks over the loopback interface
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        return make_shard_group((k,), backend, store=dist.FileStore(path, k),
                                device=self.device(rank), rank=rank)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _die_with_parent() -> None:
    """Have the kernel end this process when rank 0's process ends."""
    if sys.platform.startswith("linux"):
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


def _follow(rank: int, path: str, conn, job: Job, parent: int) -> None:
    """Rank ``rank``: plant the job's fault, join the world, set up the
    problem, answer once, then answer each command (module doc)."""
    _die_with_parent()
    if os.getppid() != parent:
        return
    os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"] = str(rank), str(job.cell.chips)
    try:
        torch.set_num_threads(job.threads)
        with planted(job.plant):
            dev = job.device(rank)
            prob, inputs = job.problem(dev, job.join(rank, path))
            cuda = dev.type == "cuda"
            built, x, tracer = {}, None, None
            conn.send(("ok", None))
            while True:
                cmd, arg = conn.recv()
                out = None
                if cmd == "build":
                    if arg not in built:
                        built[arg] = prob.runtime(arg)
                elif cmd == "inputs":
                    x = None
                    if cuda:
                        torch.cuda.reset_peak_memory_stats(dev)
                    x = inputs(arg)
                    _sync(dev)
                elif cmd == "call":
                    with profile.window() if tracer else contextlib.nullcontext():
                        built[arg](*x)
                        _sync(dev)
                    out = torch.cuda.max_memory_allocated(dev) if cuda else 0
                elif cmd == "trace":
                    tracer = profile.tracing()
                    reading = tracer.__enter__()
                elif cmd == "untrace":
                    tracer.__exit__(None, None, None)
                    tracer = None
                    out = {k: v for k, v in reading.items() if k != "breakdown"}
                elif cmd == "free":
                    built, x = {}, None
                    if cuda:
                        torch.cuda.empty_cache()
                elif cmd == "stop":
                    # NCCL's teardown waits for every rank's: rank 0 leaves
                    # the group once it has read this answer
                    conn.send(("ok", forbidden_loaded()))
                    dist.destroy_process_group()
                    return
                else:
                    raise ValueError(f"unknown command {cmd!r}")
                conn.send(("ok", out))
    except Exception:  # reported to rank 0, which ends the run with it
        tb = traceback.format_exc()
        print(f"rank {rank} failed:\n{tb}", file=sys.stderr, flush=True)
        with contextlib.suppress(OSError):
            conn.send(("error", tb))
        # a collective left open can hold the process at its exit: end it now,
        # which closes its connections, so the peers' collectives fail too
        os._exit(1)


class World:
    """Rank 0's side of a world of ``job.cell.chips`` ranks: spawns the
    followers, joins the group with them (``group``), and drives them."""

    def __init__(self, job: Job):
        k = job.cell.chips
        ctx = torch.multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="perfbench-world-")
        path = os.path.join(self._dir, "store")
        self.peaks: List[int] = []
        self._conns, self._procs = [], []
        self._done, self._closing = threading.Event(), False
        self._nccl = job.cell.config["backend"] == "nccl"
        try:
            for r in range(1, k):
                mine, theirs = ctx.Pipe()
                proc = ctx.Process(target=_follow, args=(r, path, theirs, job, os.getpid()),
                                   daemon=True)
                proc.start()
                theirs.close()
                self._conns.append(mine)
                self._procs.append(proc)
            threading.Thread(target=self._watch, daemon=True).start()
            self.group = job.join(0, path)
            self.answers()
        except BaseException:
            self.kill()
            raise

    def send(self, cmd: str, arg=None) -> None:
        for conn in self._conns:
            conn.send((cmd, arg))

    def answers(self) -> list:
        """Every follower's answer to the last command, in rank order."""
        out = [None] * len(self._conns)
        left = set(range(len(self._conns)))
        deadline = time.monotonic() + ANSWER_S
        while left:
            ready = wait([self._conns[i] for i in left] + [self._procs[i].sentinel for i in left],
                         timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(f"ranks {sorted(i + 1 for i in left)} gave no answer "
                                   f"within {ANSWER_S:g} s")
            for i in sorted(left):
                got = self._answer(i)
                if got is not None:
                    out[i] = got[0]
                    left.discard(i)
        return out

    def _answer(self, i: int):
        """(follower ``i``'s answer,) if it has given one, else None; raises
        where it failed or exited."""
        conn, proc = self._conns[i], self._procs[i]
        try:
            if conn.poll():
                status, value = conn.recv()
                if status == "error":
                    raise RuntimeError(f"rank {i + 1} failed:\n{value}")
                return (value,)
        except EOFError:
            pass
        if not proc.is_alive():
            proc.join()
            raise RuntimeError(f"rank {i + 1} exited with code {proc.exitcode} without "
                               "an answer")
        return None

    def call(self, run: Callable, max_outer: int, *args):
        """``run(*args)`` on rank 0 while every follower calls its runtime
        for ``max_outer``; each follower's peak bytes go to ``peaks``."""
        self.send("call", max_outer)
        try:
            res = run(*args)
        except Exception:
            # a collective fails here when a peer has left: its own failure
            # says why, and reaches the pipe before its connections close
            time.sleep(1.0)
            for i in range(len(self._conns)):
                self._answer(i)
            raise
        self.peaks = self.answers()
        return res

    def close(self) -> List[str]:
        """Stop the followers; the forbidden modules any of them loaded."""
        self._closing = True
        self.send("stop")
        loaded = sorted(set().union(*self.answers()))
        dist.destroy_process_group()
        self.kill(wait=60.0)
        return loaded

    def kill(self, wait: float = 0.0) -> None:
        """Give each follower ``wait`` seconds to exit, stop any still
        running, wait for each, and leave the group where it is still
        joined.  After a failure under NCCL the group is left as it is: its
        teardown waits for peers that have gone, and the process ends soon
        after."""
        self._closing = True
        for proc in self._procs:
            proc.join(timeout=wait)
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
        if dist.is_initialized() and not self._nccl:
            dist.destroy_process_group()
        shutil.rmtree(self._dir, ignore_errors=True)
        self._done.set()

    def _watch(self) -> None:
        """End rank 0's process where a follower has exited and rank 0 has
        not ended the world within ``GRACE_S``: it is held where nothing
        returns."""
        while not self._done.wait(0.5):
            gone = [i for i, p in enumerate(self._procs) if not p.is_alive()]
            if not gone or self._closing:
                continue
            if self._done.wait(GRACE_S) or self._closing:
                return
            why = f"rank {gone[0] + 1} exited with code {self._procs[gone[0]].exitcode}"
            print(f"{why}; rank 0 is held in a call that cannot return: ending the run",
                  file=sys.stderr, flush=True)
            for proc in self._procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()
            os._exit(1)
