"""Process groups for the sharded solvers, over `torch.distributed`.

The port's counterpart of the reference's `make_points_mesh`,
`make_edges_mesh` and `make_kfs_mesh`. Where the reference runs one
program over a mesh of devices (`shard_map`), the port runs one process
per device, a rank of a group: NCCL between CUDA devices, one rank on each
card, and gloo between processes on the CPU. A sharded function is called
in every rank with the whole problem, slices its own rows by
`axis_index()`, and meets the other ranks only in the three collectives
the reference uses:

* `psum`: all-reduce (sum), every rank gets the total;
* `psum_scatter`: reduce-scatter of rows, rank r gets rows r*L:(r+1)*L of
  the total (the reference's `tiled=True`);
* `all_gather`: the ranks' row blocks concatenated in rank order.

Ranks meet through a file store, never a TCP port, so groups started side
by side (test workers) cannot collide. `Group(n, device)` spawns the ranks
and runs functions in all of them (`run`, or `submit` then `result`);
`member(rank, n, store, device)` makes the calling process one rank, as a
world-size-1 caller on one card does.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)
RUN_TIMEOUT_S = 900.0       # a group call that has not answered by then is stopped


def check_device(n: int, device="cuda") -> torch.device:
    """The device type a group of `n` ranks runs on. NCCL puts one rank on
    each card, so `cuda` takes at most `torch.cuda.device_count()` ranks;
    a request the cards cannot serve raises."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"a group needs at least one rank, not {n}")
    if device.type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > have:
            raise RuntimeError(f"{n} rank(s) on cuda, but {have} CUDA device(s): NCCL puts one "
                               "rank on each card")
    elif device.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, not {device}")
    return torch.device(device.type)


@contextlib.contextmanager
def member(rank: int, world_size: int, store_path: str, device="cuda"):
    """This process as rank `rank` of a group of `world_size`, meeting the
    others through the file store at `store_path` (a file that does not
    exist yet, on a file system all ranks see). Yields the rank's device
    (card `rank` on cuda) and leaves the group on exit."""
    kind = check_device(world_size, device)
    if kind.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = kind
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store, rank=rank,
                            world_size=world_size, timeout=COLLECTIVE_TIMEOUT)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def axis_index() -> int:
    """This rank's index in the group (the reference's `lax.axis_index`)."""
    return dist.get_rank()


def size() -> int:
    return dist.get_world_size()


def rows(n_rows: int) -> slice:
    """This rank's block of `n_rows` rows: `n_rows` must be a multiple of
    the group size, as the reference's sharded axes must be of the mesh's."""
    n = size()
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not split over {n} ranks")
    per = n_rows // n
    return slice(axis_index() * per, (axis_index() + 1) * per)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the ranks, on every rank."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y)
    return y


def psum_scatter(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of the sum of `x` [n*L, ...] over the
    ranks: [L, ...]."""
    x = x.contiguous()
    n = size()
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks")
    parts = list(x.chunk(n))
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts)
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's `x` [L, ...] concatenated in rank order: [n*L, ...]."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _to(obj, device):
    """`obj` with every tensor in it (in tuples, named tuples and dicts)
    moved to `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [_to(o, device) for o in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj


def _rank_main(rank: int, world_size: int, store_path: str, device: str, tasks, results):
    """A spawned rank: join the group, then run each task it is sent until
    it is sent None. Rank 0 sends back its result, every rank a report."""
    torch.set_num_threads(1)
    with member(rank, world_size, store_path, device) as dev:
        while True:
            task = tasks.get()
            if task is None:
                return
            fn, args, kwargs = pickle.loads(task)
            try:
                out = fn(*_to(args, dev), **_to(kwargs, dev))
                reply = (rank, True, _to(out, "cpu") if rank == 0 else None)
            except Exception:  # noqa: BLE001 - reported to the caller, which stops the group
                reply = (rank, False, traceback.format_exc())
            results.put(pickle.dumps(reply))


class Group:
    """`n` spawned ranks of one group on `device` (cuda: NCCL, one card
    each; cpu: gloo), each with one CPU thread, kept for as many calls of
    `run` as the caller makes. Close it, or use it as a context manager.
    The file store lies in `store_dir` (a fresh temporary directory by
    default)."""

    def __init__(self, n: int, device="cuda", store_dir=None):
        self.device = check_device(n, device)
        self.n = n
        self._pending = False
        self._own_dir = tempfile.mkdtemp(prefix="group-") if store_dir is None else None
        store = os.path.join(self._own_dir or store_dir, f"store-{os.urandom(8).hex()}")
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.SimpleQueue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, store, self.device.type, self._tasks[r],
                                         self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs):
        """`fn(*args, **kwargs)` in every rank, its tensors moved to the
        rank's device; returns rank 0's result on the CPU. `fn` must be
        importable by name (a module-level function). A rank that raises
        or dies stops the group, and the error is raised here."""
        self.submit(fn, *args, **kwargs)
        return self.result()

    def submit(self, fn, *args, **kwargs):
        """Start `run`'s work and return at once; `result()` waits for it,
        so the caller can work meanwhile. One call at a time."""
        if not self._procs:
            raise RuntimeError("the group is closed")
        if self._pending:
            raise RuntimeError("the group is still running a call")
        task = pickle.dumps((fn, args, kwargs))
        for q in self._tasks:
            q.put(task)
        self._pending = True

    def result(self):
        """Rank 0's result of the call `submit` started."""
        if not self._pending:
            raise RuntimeError("no call is running")
        out, done, waited = None, 0, 0.0
        while done < self.n:
            try:
                rank, ok, value = pickle.loads(self._results.get(timeout=1.0))
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead or waited > RUN_TIMEOUT_S:
                    self._stop()
                    raise RuntimeError(f"rank(s) {dead} died" if dead else
                                       f"no answer from the group in {RUN_TIMEOUT_S} s")
                continue
            if not ok:
                self._stop()
                raise RuntimeError(f"rank {rank} of {self.n} failed:\n{value}")
            if rank == 0:
                out = value
            done += 1
        self._pending = False
        return out

    def _stop(self):
        self._pending = False
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join(timeout=10)
        self._procs = []
        self._cleanup()

    def _cleanup(self):
        if self._own_dir is not None:
            shutil.rmtree(self._own_dir, ignore_errors=True)
            self._own_dir = None

    def close(self):
        """Send every rank its stop, wait for each to leave the group, and
        stop any that does not within 60 s."""
        if self._pending and self._procs:
            self.result()
        for q in self._tasks if self._procs else []:
            q.put(None)
        for p in self._procs:
            p.join(timeout=60)
        self._stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
