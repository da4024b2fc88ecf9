"""Gloo ranks on the CPU for the mesh tests (imports no JAX).

``run_ranks(fn, world, *args)`` starts ``world`` spawned processes, each
joining one gloo group on a free port that this process binds first, and
returns what ``fn(rank, world, *args)`` returned on each rank (``Ranks``
starts them and returns at once, for work in this process meanwhile). ``fn`` must
live in a module that imports no JAX (``_torch_mesh_ranks``). A collective
that waits 30 s for its peers raises, and the ranks are joined under a
hard limit: a hung rank is killed and the call fails within ``timeout``
seconds.
"""
import datetime
import os
import socket
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, out_dir, timeout, args):
    torch.set_num_threads(1)
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank), "GLOO_SOCKET_IFNAME": "lo"})
    import torch.distributed as dist
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=min(30, max(5, timeout // 2))))
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """``world`` gloo ranks running ``fn(rank, world, *args)``, started at
    once; :meth:`result` joins them (within ``timeout`` seconds of the
    start) and returns each rank's value, or raises with a rank's
    traceback, killing every rank still alive."""

    def __init__(self, fn, world: int, *args, timeout: float = 60.0):
        ctx = mp.get_context("spawn")
        port = free_port()
        self._dir = tempfile.TemporaryDirectory()
        self.world, self.timeout = world, timeout
        self.deadline = time.time() + timeout
        self.procs = [ctx.Process(target=_entry,
                                  args=(fn, r, world, port, self._dir.name,
                                        int(timeout), args), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def result(self):
        out_dir, procs = self._dir.name, self.procs
        try:
            for p in procs:
                p.join(max(0.0, self.deadline - time.time()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
            errs = []
            for r in range(self.world):
                path = os.path.join(out_dir, f"{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {r}:\n{f.read()}")
            if errs:
                raise AssertionError("\n".join(errs))
            if hung:
                raise AssertionError(f"ranks {hung} did not finish within "
                                     f"{self.timeout} s (killed)")
            bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
            if bad:
                raise AssertionError(f"ranks exited with {bad}")
            return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                               weights_only=False) for r in range(self.world)]
        finally:
            self._dir.cleanup()


def run_ranks(fn, world: int, *args, timeout: float = 60.0):
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]`` from
    ``world`` gloo ranks (:class:`Ranks`)."""
    return Ranks(fn, world, *args, timeout=timeout).result()
