"""Starting the ranks of a multi-device run: one spawned process per
device, joined into one process group.

:func:`run_ranks` runs ``fn(rank, world_size, *args)`` in ``world_size``
processes started with ``spawn``, after each has joined the group through a
``file://`` rendezvous (no TCP port to collide on) and set ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``. Rank r takes ``cuda:r`` under NCCL.
The parent waits at most ``timeout`` seconds and then kills every child, so
a collective that never completes fails one call instead of hanging. A
child that exits with a code (``SystemExit``) makes the parent raise
``torch.multiprocessing.ProcessExitedException``; one that raises, a
``ProcessRaisedException`` with its traceback.

``cli.main`` starts its ranks here (:func:`cli_rank`) when more than one
device is asked for and no ``RANK`` is set, and ``serve.main`` likewise
(:func:`serve_rank`); under ``torchrun`` each joins the group that is
already there instead. A Ctrl-C (SIGINT) while the parent waits gives the
ranks ``grace`` seconds to stop by themselves before they are killed. This
module imports neither the CLI nor anything that a test module imports at
its top.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_entry(rank: int, world_size: int, init_method: str, backend: str,
                threads: Optional[int], fn: Callable, args: tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank))
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo",
              timeout: Optional[float] = None, threads: Optional[int] = None,
              rendezvous_dir: Optional[str] = None,
              grace: float = 30.0) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    of one process group (``backend`` gloo or nccl) and wait for all of
    them; ``fn`` and ``args`` must pickle (``fn`` by its module path).
    ``threads`` sets each child's torch thread count. Raises
    ``TimeoutError`` after ``timeout`` seconds, the children killed. On
    ``KeyboardInterrupt`` the children get ``grace`` seconds to finish
    (a Ctrl-C reaches them too) before they are killed; it returns when
    they finished cleanly."""
    own_dir = rendezvous_dir is None
    rdzv = (tempfile.mkdtemp(prefix="favit-rdzv-") if own_dir
            else rendezvous_dir)
    init_method = f"file://{os.path.join(os.path.abspath(rdzv), 'store')}"
    ctx = mp.start_processes(
        _rank_entry,
        args=(world_size, init_method, backend, threads, fn, args),
        nprocs=world_size, start_method="spawn", join=False)
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of "
                        f"{getattr(fn, '__name__', fn)} did not finish in "
                        f"{timeout} s; killed")
        except KeyboardInterrupt:
            end = time.monotonic() + grace
            while not ctx.join(timeout=1.0):
                if time.monotonic() > end:
                    raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if own_dir:
            shutil.rmtree(rdzv, ignore_errors=True)


def cli_rank(rank: int, world_size: int, argv: list) -> None:
    """One rank of ``cli.main(argv)`` (which keeps ranks other than 0
    quiet)."""
    from focused_attention_vit_tpu_torch import cli

    cli.main(argv)


def serve_rank(rank: int, world_size: int, argv: list) -> None:
    """One rank of ``serve.main(argv)``."""
    from focused_attention_vit_tpu_torch import serve

    serve.main(argv)


def launch_serve(argv: list, world_size: int, backend: str) -> None:
    """Serve ``serve.main(argv)`` from ``world_size`` spawned ranks until
    they stop."""
    threads = None
    if backend == "gloo":
        threads = max(1, (os.cpu_count() or 1) // world_size)
    run_ranks(serve_rank, world_size, list(argv), backend=backend,
              threads=threads)


def launch_cli(argv: list, world_size: int, backend: str) -> None:
    """Run ``cli.main(argv)`` on ``world_size`` spawned ranks; a rank's
    exit code 143 (preempted, checkpoint committed) is the parent's."""
    threads = None
    if backend == "gloo":
        threads = max(1, (os.cpu_count() or 1) // world_size)
    try:
        run_ranks(cli_rank, world_size, list(argv), backend=backend,
                  threads=threads)
    except mp.ProcessExitedException as e:
        if e.exit_code == 143:
            raise SystemExit(143) from e
        raise
