"""Start the ranks of a sharded converge as processes on one host.

The reference needs no launcher: JAX drives every device of its mesh
from one controller.  The port runs one process a rank (SPMD), so
``run_ranks`` spawns them, joins them into one ``torch.distributed``
group and brings their results back::

    from protocol_tpu_torch.parallel.launch import run_ranks
    results = run_ranks(8, fn, graph, backend="gloo", device="cpu", timeout_s=60)

``fn(mesh, *args)`` runs in every rank; it and its arguments are
pickled, so ``fn`` must be a module-level function of an importable
module.  The collective backend and the device are the caller's choice,
never the launcher's.  Arrays too large to pickle once a rank are
written once with ``share_arrays`` and mapped by each rank with
``map_arrays``.

A caller may also set the ranks' schedule: the order in which they are
started and a pause between starts, each rank's intra-op thread count
(``OMP_NUM_THREADS`` beside it) and extra environment
(``PYTHONHASHSEED`` among it).  The defaults are rank order, no pause,
one thread and the parent's environment.  A rank reads what it was
given with ``rank_schedule()``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pathlib
import pickle
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import wait

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import default_mesh, rank_device

#: Collective backends a caller may name.
BACKENDS = ("gloo", "nccl")

#: Held while a launch starts its ranks: a spawned child inherits the
#: parent's ``os.environ`` as it starts, and a launch with a schedule
#: sets its environment there for that while.
_ENV_LOCK = threading.Lock()

#: What the launcher applied in this rank (``rank_schedule``).
_SCHEDULE: dict = {}


def run_ranks(size: int, fn, *args, backend: str, device, timeout_s: float,
              start_order=None, stagger_s: float = 0.0, threads: int | None = None,
              env: dict | None = None) -> list:
    """Run ``fn(mesh, *args)`` in ``size`` spawned ranks of one process
    group and return each rank's result, rank by rank, with every tensor
    in it turned into a numpy array.

    ``start_order`` lists the ranks in the order they are started (rank
    order when None), with ``stagger_s`` seconds between two starts;
    each rank runs ``threads`` intra-op threads (one when None) and, when
    ``threads`` is given, starts with ``OMP_NUM_THREADS`` set to it;
    ``env`` is set in the ranks' environment on top of the parent's.  The
    parent's own ``os.environ`` carries both only while the ranks start,
    under a lock that every launch holds while it starts its ranks.

    The group meets through a ``file://`` store in a temporary directory
    (no TCP port, so concurrent launches cannot collide), with
    ``timeout_s`` as its collective timeout.  ``device`` is each rank's
    device as ``mesh.rank_device`` reads it (``None`` or ``"cuda"``: the
    rank's card).  A rank that fails or dies fails the launch at once,
    with its traceback where it left one; once ``timeout_s`` has passed,
    every rank still running is killed and ``TimeoutError`` raised.
    Every child is gone when this returns or raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown collective backend {backend!r}; name one of {BACKENDS}")
    if size < 1:
        raise ValueError(f"a launch needs at least one rank, got {size}")
    order = list(range(size)) if start_order is None else [int(r) for r in start_order]
    if sorted(order) != list(range(size)):
        raise ValueError(f"start_order {order} is not an order of the {size} ranks")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="run_ranks-") as tmp:
        out = pathlib.Path(tmp)
        # The job goes through a file, not the spawn pipe: a child reads
        # the pipe as it unpickles, so a large argument would hold each
        # start until that child had imported the job's modules.
        with open(out / "job.pkl", "wb") as f:
            pickle.dump((fn, args), f)
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(rank, size, tmp, backend, device, timeout_s,
                      {"start_position": order.index(rank),
                       "threads": 1 if threads is None else int(threads)}),
                name=f"rank-{rank}",
            )
            for rank in range(size)
        ]
        started = []
        try:
            extra = dict(env or {})
            if threads is not None:
                extra["OMP_NUM_THREADS"] = int(threads)
            with _environment(extra):
                for i, rank in enumerate(order):
                    if i and stagger_s:
                        time.sleep(stagger_s)
                    procs[rank].start()
                    started.append(procs[rank])
            _join(procs, out, timeout_s)
        finally:
            for proc in started:
                if proc.is_alive():
                    proc.kill()
            for proc in started:
                proc.join()
        results = []
        for rank in range(size):
            with open(out / f"rank{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


@contextlib.contextmanager
def _environment(extra: dict):
    """``os.environ`` with ``extra`` set on top, and restored on exit, all
    under ``_ENV_LOCK`` (taken even when ``extra`` is empty, so that no
    launch starts its ranks while another's environment is set)."""
    with _ENV_LOCK:
        saved = {k: os.environ.get(k) for k in extra}
        os.environ.update({k: str(v) for k, v in extra.items()})
        try:
            yield
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def rank_schedule(mesh=None) -> dict:
    """In a rank that ``run_ranks`` started: its rank, its place in the
    start order, the ``PYTHONHASHSEED`` and ``OMP_NUM_THREADS`` it
    started with and its intra-op thread count (empty elsewhere).
    ``mesh`` is ignored, so that ``run_ranks`` can run this as a rank's
    program."""
    return dict(_SCHEDULE)


def _join(procs, out: pathlib.Path, timeout_s: float) -> None:
    """Wait until every rank exits 0; raise at the first that does not,
    or once ``timeout_s`` has passed."""
    deadline = time.monotonic() + timeout_s
    pending = {proc.sentinel: rank for rank, proc in enumerate(procs)}
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(
                f"ranks {sorted(pending.values())} of {len(procs)} still ran after "
                f"{timeout_s} s and were killed"
            )
        for sentinel in wait(list(pending), timeout=left):
            rank = pending.pop(sentinel)
            procs[rank].join()  # the sentinel fires just before the exit status is ready
            code = procs[rank].exitcode
            if code != 0:
                err = out / f"rank{rank}.err"
                detail = err.read_text() if err.exists() else "(no traceback: the process died)"
                raise RuntimeError(
                    f"rank {rank} of {len(procs)} exited with code {code}:\n{detail}"
                )


def _rank_main(rank, size, tmp, backend, device, timeout_s, schedule) -> None:
    out = pathlib.Path(tmp)
    try:
        with open(out / "job.pkl", "rb") as f:
            fn, args = pickle.load(f)
        # One intra-op thread a rank unless the caller asks for more: the
        # ranks are the parallelism, and thread pools of several
        # processes oversubscribe the host's cores.
        torch.set_num_threads(schedule["threads"])
        _SCHEDULE.update(
            rank=rank, start_position=schedule["start_position"],
            hashseed=os.environ.get("PYTHONHASHSEED"),
            omp_num_threads=os.environ.get("OMP_NUM_THREADS"),
            threads=torch.get_num_threads(),
        )
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{out / 'store'}", rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            result = fn(default_mesh(device=dev), *args)
        finally:
            dist.destroy_process_group()
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(_host(result), f)
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _host(x):
    """``x`` with every tensor in it (in dicts, lists and tuples) as a
    numpy array on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def share_arrays(directory, arrays: dict) -> dict[str, str]:
    """Write each array of ``arrays`` to ``directory/<name>.npy`` once;
    returns the paths by name, small enough to pass to every rank."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, a in arrays.items():
        paths[name] = str(directory / f"{name}.npy")
        np.save(paths[name], np.asarray(a))
    return paths


def map_arrays(paths: dict) -> dict[str, np.ndarray]:
    """The arrays ``share_arrays`` wrote, mapped read-only: the ranks of
    one host share their pages instead of holding a copy each."""
    return {name: np.load(path, mmap_mode="r") for name, path in paths.items()}
