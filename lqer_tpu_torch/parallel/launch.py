"""Run one function on several ranks: spawned processes joined in one
default process group (``torch.distributed`` over ``tcp://127.0.0.1``).

``run_ranks(fn, n, backend=..., device=...)`` starts ``n`` processes
(start method ``spawn``), each joining the group as rank r, then calls
``fn(*args)`` and sends its result (picklable: numbers, numpy arrays,
dicts of them) back. It returns the results in rank order;
``start_ranks`` starts them and returns at once (the caller works beside
the ranks, then collects). A rank that
raises, dies or outlives ``timeout`` fails the call: every rank is
stopped and the error raised here. On ``device="cuda"`` rank r works on
``cuda:(r % device_count)`` (several ranks share a card when there are
more ranks than cards; only ``gloo`` takes that).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import socket
import time
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n_ranks, port, backend, device, timeout, threads, fn,
               args, results):
    import torch
    import torch.distributed as dist

    from .mesh import initialize_multihost

    try:
        torch.set_num_threads(threads)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        initialize_multihost(f"127.0.0.1:{port}", n_ranks, rank,
                             backend=backend, device_type=device,
                             timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


class RankGroup:
    """Ranks started by :func:`start_ranks`; :meth:`results` waits for
    them."""

    def __init__(self, fn, n_ranks, backend, device, args, timeout,
                 threads):
        ctx = mp.get_context("spawn")
        self._queue = ctx.Queue()
        self.n_ranks = n_ranks
        self.timeout = timeout
        port = _free_port()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n_ranks, port, backend, device,
                                         timeout, threads, fn, args,
                                         self._queue))
                       for r in range(n_ranks)]
        self._deadline = time.monotonic() + timeout
        for p in self._procs:
            p.start()

    def results(self) -> list:
        """Each rank's result in rank order; raises if a rank raised, died
        or outlived the timeout (every rank is stopped first)."""
        out: dict = {}
        procs = self._procs
        try:
            while len(out) < self.n_ranks:
                try:
                    rank, ok, payload = self._queue.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in out]
                    if dead:
                        raise RuntimeError(
                            f"ranks {dead} exited without a result (exit "
                            f"codes {[procs[r].exitcode for r in dead]})")
                    if time.monotonic() > self._deadline:
                        missing = sorted(set(range(self.n_ranks)) - set(out))
                        raise TimeoutError(f"ranks {missing} gave no result "
                                           f"within {self.timeout}s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(timeout=max(1.0, self._deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [out[r] for r in range(self.n_ranks)]


def start_ranks(fn, n_ranks: int, *, backend: str, device: str = "cuda",
                args: tuple = (), timeout: float = 300.0,
                threads: int = 1) -> RankGroup:
    """Start ``fn(*args)`` on ``n_ranks`` spawned processes, each with
    ``threads`` intra-op threads; the caller collects with
    ``.results()``."""
    return RankGroup(fn, n_ranks, backend, device, args, timeout, threads)


def run_ranks(fn, n_ranks: int, *, backend: str, device: str = "cuda",
              args: tuple = (), timeout: float = 300.0,
              threads: int = 1) -> list:
    """``[fn(*args) on rank r for r in range(n_ranks)]``."""
    return start_ranks(fn, n_ranks, backend=backend, device=device,
                       args=args, timeout=timeout, threads=threads).results()


__all__ = ["RankGroup", "run_ranks", "start_ranks"]
