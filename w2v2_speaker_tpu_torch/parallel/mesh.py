"""Ranks, groups and the collectives of data parallelism.

Counterpart of ``w2v2_speaker_tpu/parallel/mesh.py``. The JAX package
shards the global batch over a ``('data', 'model')`` device mesh
(``create_mesh`` :34, ``shard_batch`` :108) and lets GSPMD compute every
cross-row quantity over the global batch. Here every rank is a process
with a ``torch.distributed`` group; ``Mesh`` holds its rank, the world,
the ``data`` and ``model`` groups and its device, in the JAX layout: rank
``r`` is data rank ``r // model`` and model rank ``r % model`` (model
minor).

The train step runs the JAX row layout explicitly (``select_rows``): the
global batch is cut into ``acc`` contiguous microbatches first, and data
rank ``d`` takes the ``d``-th of ``data`` contiguous blocks of each. While
a microbatch runs, ``shard_rows`` says where the rank's block lies in it
(``active_rows``), and the cross-row quantities reduce over the data group:

- ``global_mean``: loss and metric means over the global microbatch
  (padding-weighted ones divide by the global weight sum);
- ``global_sum``: a differentiable all-reduce (BatchNorm's sums);
- ``gather_rows``: a differentiable all-gather (triplet mining, the
  training embeddings).

Every rank thus computes the global loss. Each all-reduce's backward
sums the ranks' equal upstream gradients, so a rank's gradient is
``data`` times its rows' share of the global gradient, and the ranks'
sum is ``data`` times the global gradient: ``all_reduce_grads`` sums the
gradients in one flat collective and divides by ``data``. Outside a sharded
microbatch (one rank, or no mesh) each helper is the one-process
expression it replaces, so a world of 1 computes what it always did.

Collectives on a gloo group stage CUDA tensors through the host (two
ranks sharing one card run over gloo: NCCL refuses one card twice).
Every group has a timeout (``group_timeout``: 600 s, or the ``timeout``
that ``spawn`` gave the rank): a rank that waits past it raises.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
import pathlib
import pickle
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.collate import pad_batch_rows
from ..device import DeviceError

__all__ = [
    "Mesh", "RowShard", "active_rows", "all_gather_rows", "all_reduce_grads",
    "barrier", "broadcast_object", "create_mesh", "current_mesh", "gather_rows", "global_mean", "global_sum", "group_timeout",
    "needs_spawn", "pad_batch_rows", "resolve_num_devices", "row_indices", "select_rows", "shard_map_rows",
    "shard_rows", "shared_iter", "spawn", "strip_host_fields", "sub_mesh", "use_mesh",
]

GROUP_TIMEOUT_S = 600.0  # a spawned rank holds its spawn's ``timeout`` here


def group_timeout() -> datetime.timedelta:
    """Every group's timeout: ``GROUP_TIMEOUT_S`` seconds."""
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


@dataclass(eq=False)
class Mesh:
    """One rank's view of the ``('data', 'model')`` mesh. A world of 1 has
    no groups and every collective of this module is a no-op on it."""

    rank: int
    world: int
    model: int
    device: torch.device
    backend: str = "none"
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None  # gloo, every rank: host objects and barriers

    @property
    def data(self) -> int:
        return self.world // self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        return self.world > 1


def resolve_num_devices(num_devices, device: torch.device) -> int:
    """``trainer.num_devices``: ``all`` is every visible card (1 on the CPU),
    else a positive int."""
    if num_devices in (None, "all"):
        return max(torch.cuda.device_count(), 1) if device.type == "cuda" else 1
    n = int(num_devices)
    if n < 1:
        raise ValueError(f"trainer.num_devices must be >= 1 or 'all', got {num_devices!r}")
    return n


def check_cards(n: int, device: torch.device) -> None:
    """Raise for more ranks on the card than there are cards (the JAX
    package narrows to the devices it has, ``runtime/experiment.py:945-948``;
    this port does not carry on with fewer)."""
    if device.type == "cuda" and n > 1 and n > torch.cuda.device_count():  # one rank: resolve_device says
        raise DeviceError(
            f"trainer.num_devices={n} asks for {n} cards and {torch.cuda.device_count()} are present: "
            "one rank a card; nothing narrows the world")


def needs_spawn(n: int) -> bool:
    """True where a world of ``n`` has to be started here: no process group
    and no torchrun environment."""
    return n > 1 and not dist.is_initialized() and "WORLD_SIZE" not in os.environ


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % max(torch.cuda.device_count(), 1))


def create_mesh(num_devices=1, model: int = 1, device=None) -> Mesh:
    """The mesh of this rank over ``num_devices`` ranks (``model`` of them
    a tensor-parallel group). The world is, in this order: the process
    group that exists, taken as given (a caller's or torchrun's), whose
    size must be ``num_devices``; torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` (NCCL on the card, gloo on the CPU); a world of 1. A
    world of more ranks with neither is started with ``spawn``, which
    makes the group before the ranks call this. On the card each rank
    takes card ``LOCAL_RANK`` (else its rank) modulo the cards present."""
    dev = torch.device("cuda" if device is None else device)
    n = resolve_num_devices(num_devices, dev)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            if int(os.environ["WORLD_SIZE"]) != n:
                raise ValueError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} but trainer.num_devices={n}")
            check_cards(n, dev)
            if dev.type == "cuda":
                torch.cuda.set_device(_rank_device(dev, int(os.environ.get("RANK", 0))))
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                                    timeout=group_timeout())
        elif n > 1:
            raise RuntimeError(f"a world of {n} ranks needs a process group: start it with spawn() or torchrun")
        else:
            if model != 1:
                raise ValueError(f"model={model} needs {model} ranks")
            return Mesh(0, 1, 1, dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"the process group has {world} ranks but trainer.num_devices={n}")
    if world % model:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    dev = _rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = dist.get_backend()
    timeout = group_timeout()
    data = world // model
    data_group, model_group = dist.group.WORLD, None
    if model > 1:  # every rank makes every group, in one order
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)], timeout=timeout)
            if rank % model == m:
                data_group = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)], timeout=timeout)
            if rank // model == d:
                model_group = g
    host_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    return Mesh(rank, world, model, dev, backend, data_group, model_group, host_group)


def sub_mesh(mesh: Mesh, size: int) -> Optional[Mesh]:
    """A data-parallel mesh (model 1) over the world's first ``size``
    ranks, None on the others; every rank must call it."""
    if not mesh.distributed:
        return mesh
    timeout = group_timeout()
    group = dist.new_group(list(range(size)), timeout=timeout)
    host = group if mesh.backend == "gloo" else dist.new_group(list(range(size)), backend="gloo", timeout=timeout)
    if mesh.rank >= size:
        return None
    return Mesh(mesh.rank, size, 1, mesh.device, mesh.backend, group, None, host)


_MESH: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """``mesh`` is the run's mesh (``current_mesh``) for the block."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def current_mesh() -> Optional[Mesh]:
    """The mesh of the run in progress (``use_mesh``), None outside one."""
    return _MESH


# ------------------------------------------------------------- host helpers


def strip_host_fields(batch: dict) -> dict:
    """The batch without its host-only fields (keys, transcriptions, ...):
    the entries with a shape, and scalars (:62)."""
    return {k: v for k, v in batch.items() if hasattr(v, "shape") or np.isscalar(v)}


def row_indices(rows: int, data: int, data_rank: int, acc: int = 1) -> np.ndarray:
    """The global rows of ``data_rank``'s block of each of ``acc``
    contiguous microbatches of ``rows`` rows, microbatch by microbatch:
    microbatch ``m`` is rows ``[m rows / acc, (m + 1) rows / acc)`` and the
    rank takes the ``data_rank``-th of ``data`` contiguous blocks of it
    (where ``jax.device_put`` with the data-axis sharding puts them)."""
    if rows % (acc * data):
        raise ValueError(f"{rows} rows not divisible by {acc} microbatches x {data} data ranks")
    micro, block = rows // acc, rows // (acc * data)
    return np.concatenate([np.arange(m * micro + data_rank * block, m * micro + (data_rank + 1) * block)
                           for m in range(acc)])


def select_rows(batch: dict, mesh: Optional[Mesh], acc: int = 1, stacked: bool = False) -> dict:
    """This rank's rows of every array of ``batch`` (``row_indices``; axis 1
    of a ``[K, B, ...]`` stacked batch), host-only fields dropped; the
    batch as it is on one data rank."""
    if mesh is None or mesh.data == 1:
        return batch
    axis = 1 if stacked else 0
    arrays = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
    rows = next(iter(arrays.values())).shape[axis]
    idx = row_indices(rows, mesh.data, mesh.data_rank, acc)
    if (idx == np.arange(idx[0], idx[0] + len(idx))).all():  # one block: a view
        return {k: v[:, idx[0]:idx[0] + len(idx)] if stacked else v[idx[0]:idx[0] + len(idx)]
                for k, v in arrays.items()}
    return {k: v[:, idx] if stacked else v[idx] for k, v in arrays.items()}


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.distributed:
        dist.barrier(group=mesh.host_group)


def broadcast_object(obj: Any, mesh: Optional[Mesh]) -> Any:
    """Rank 0's ``obj`` on every rank (pickled, over the host group)."""
    if mesh is None or not mesh.distributed:
        return obj
    box = [obj if mesh.is_main else None]
    dist.broadcast_object_list(box, src=0, group=mesh.host_group)
    return box[0]


class _End:
    pass


class _Failed:
    def __init__(self, text: str):
        self.text = text


def shared_iter(items: Optional[Iterable], mesh: Optional[Mesh]) -> Iterator:
    """Rank 0 iterates ``items`` and every rank yields what it yields, one
    broadcast an item; the end, or rank 0's error, reaches every rank
    (the others raise too). The ranks must draw in step, as ranks that
    run the same host code on the same data do."""
    if mesh is None or not mesh.distributed:
        yield from items
        return
    it = iter(items) if mesh.is_main else None
    while True:
        item = None
        if mesh.is_main:
            try:
                item = next(it, _End())
            except BaseException as e:
                broadcast_object(_Failed(f"{type(e).__name__}: {e}"), mesh)
                raise
        item = broadcast_object(item, mesh)
        if isinstance(item, _End):
            return
        if isinstance(item, _Failed):
            raise RuntimeError(f"rank 0's data pipeline failed: {item.text}")
        yield item


# ------------------------------------------------------- device collectives


def _all_reduce_(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` (the data group) in place."""
    group = mesh.data_group if group is None else group
    if mesh.backend == "gloo" and t.is_cuda:
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def _all_gather(t: torch.Tensor, mesh: Mesh, size: int, group) -> torch.Tensor:
    src = t.contiguous().cpu() if mesh.backend == "gloo" and t.is_cuda else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


class _AllSum(torch.autograd.Function):
    """All-reduce sum over the data group; the backward sums too (each
    rank's loss holds the global loss, see the module docstring)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(x.detach().clone().contiguous(), mesh)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone().contiguous(), ctx.mesh), None


class _GatherRows(torch.autograd.Function):
    """All-gather along rows over the data group; the backward sums the
    gradient over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return _all_gather(x.detach(), mesh, mesh.data, mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.clone().contiguous(), ctx.mesh)
        r = ctx.mesh.data_rank * ctx.rows
        return g[r:r + ctx.rows], None


@dataclass(frozen=True)
class RowShard:
    """Where this rank's rows lie in the global microbatch being run."""

    offset: int
    rows: int
    total: int
    mesh: Mesh

    def take(self, x):
        """This rank's rows of a global-microbatch ``x``."""
        return x[self.offset:self.offset + self.rows]


_ROWS: Optional[RowShard] = None


@contextlib.contextmanager
def shard_rows(mesh: Optional[Mesh], rows: int):
    """For the block: this rank's ``rows`` are block ``mesh.data_rank`` of
    a global microbatch of ``rows * mesh.data``. No-op on one data rank."""
    global _ROWS
    if mesh is None or mesh.data == 1:
        yield None
        return
    prev, _ROWS = _ROWS, RowShard(mesh.data_rank * rows, rows, rows * mesh.data, mesh)
    try:
        yield _ROWS
    finally:
        _ROWS = prev


def active_rows() -> Optional[RowShard]:
    """The row shard of the microbatch being run, None outside one."""
    return _ROWS


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks of the active shard (differentiable);
    ``x`` outside one."""
    s = _ROWS
    return x if s is None else _AllSum.apply(x, s.mesh)


def global_mean(values: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean of ``values`` over the global microbatch: plain, or weighted
    by ``weights`` over max(sum of weights, 1). Outside a shard,
    ``values.mean()`` and ``(values * w).sum() / w.sum().clamp_min(1)``."""
    s = _ROWS
    if weights is None:
        if s is None:
            return values.mean()
        count = torch.tensor(float(values.numel()), dtype=values.dtype, device=values.device)
        tot = _AllSum.apply(torch.stack([values.sum(), count]), s.mesh)
        return tot[0] / tot[1]
    w = weights.to(values.dtype)
    num, den = (values * w).sum(), w.sum()
    if s is not None:
        tot = _AllSum.apply(torch.stack([num, den]), s.mesh)
        num, den = tot[0], tot[1]
    return num / den.clamp_min(1.0)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global microbatch's rows of ``x`` (differentiable all-gather over
    the active shard's data group); ``x`` outside one."""
    s = _ROWS
    return x if s is None else _GatherRows.apply(x, s.mesh)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data rank's rows of ``x``, in rank order (no gradient)."""
    if mesh is None or mesh.data == 1:
        return x
    return _all_gather(x.detach(), mesh, mesh.data, mesh.data_group)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Optional[Mesh]) -> None:
    """Every gradient summed over the data group in one flat all-reduce
    (one a dtype), then divided by ``data``: the ranks' sum is ``data``
    times the global gradient (module docstring). A parameter without a gradient (a layer that layerdrop
    skipped) contributes zeros and gets the reduced values. No-op on one
    data rank."""
    if mesh is None or mesh.data == 1:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        _all_reduce_(flat, mesh).div_(mesh.data)
        o = 0
        for p in ps:
            n = p.numel()
            p.grad.copy_(flat[o:o + n].view_as(p.grad))
            o += n


def shard_map_rows(fn: Callable, batch: dict, mesh: Optional[Mesh], mask_fill: bool = False):
    """``fn`` over the rows of a host ``batch`` (numpy arrays, rows
    leading) sharded over the data ranks: the rows padded to a multiple of
    ``data`` (``pad_batch_rows``, ``mask`` filled with ``mask_fill``), each
    rank's contiguous block through ``fn``, the outputs (a tensor or a
    tuple of them, rows leading) gathered and cut back to the batch's
    rows. ``fn(batch)`` on one data rank."""
    if mesh is None or mesh.data == 1:
        return fn(batch)
    arrays = strip_host_fields(batch)
    n = next(iter(arrays.values())).shape[0]
    padded = pad_batch_rows(arrays, -(-n // mesh.data) * mesh.data, mask_fill=mask_fill)
    out = fn(select_rows(padded, mesh))
    single = isinstance(out, torch.Tensor)
    gathered = tuple(all_gather_rows(o, mesh)[:n] for o in ((out,) if single else out))
    return gathered[0] if single else gathered


# ------------------------------------------------------------------- spawn


def _rank_main(rank: int, world: int, root: str, device_type: str, backend: str, timeout_s: float,
               threads: Optional[int]) -> None:
    global GROUP_TIMEOUT_S
    GROUP_TIMEOUT_S = timeout_s
    if threads:
        torch.set_num_threads(threads)
    log = None
    if rank:
        log = open(pathlib.Path(root) / f"rank{rank}.log", "w", buffering=1)
        sys.stdout = sys.stderr = log
    if device_type == "cuda":
        torch.cuda.set_device(rank % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn, args = pickle.loads((pathlib.Path(root) / "call.pkl").read_bytes())
        out = fn(*args)
        if rank == 0:
            tmp = pathlib.Path(root) / "result.pkl.part"
            tmp.write_bytes(pickle.dumps(out))
            tmp.rename(pathlib.Path(root) / "result.pkl")
    except BaseException as e:
        traceback.print_exc()
        try:
            (pathlib.Path(root) / f"error{rank}.pkl").write_bytes(pickle.dumps(e))
        except Exception:
            pass
        sys.stdout.flush()
        os._exit(1)  # no teardown that could wait on a rank that hangs
    dist.destroy_process_group()
    if log is not None:
        log.flush()


def spawn(fn: Callable, args: tuple = (), nprocs: int = 2, device: str = "cpu", deadline: Optional[float] = None,
          timeout: Optional[float] = None, threads: Optional[int] = None, backend: Optional[str] = None) -> Any:
    """``fn(*args)`` on ``nprocs`` fresh processes of this host, each one
    rank of a default process group (gloo on the CPU, NCCL with a card a
    rank on the card) met through a ``file://`` rendezvous in a temporary
    directory; returns rank 0's result. ``fn`` must be importable by the
    child (a module-level function). ``fn`` and ``args`` reach the ranks
    pickled in that directory, not through each child's start-up pipe,
    which blocks the start of the next rank, beyond any deadline, once it
    holds more than the pipe's buffer and the child dies before reading it
    (a script without a ``__main__`` guard). Ranks other than 0 write their output
    to a log that is printed when they fail. A rank that fails ends the
    others and re-raises its error here; past ``deadline`` seconds every
    rank is killed and ``TimeoutError`` raised. ``timeout`` is every
    group's timeout (default ``group_timeout``), ``threads`` each rank's
    intra-op threads. ``backend="gloo"`` on the card lets ranks share a
    card (rank ``r`` on card ``r`` modulo the cards present)."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        check_cards(nprocs, dev)
    timeout_s = group_timeout().total_seconds() if timeout is None else float(timeout)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="w2v2_ranks_") as root:
        (pathlib.Path(root) / "call.pkl").write_bytes(pickle.dumps((fn, args)))
        procs = [ctx.Process(target=_rank_main, args=(r, nprocs, root, dev.type, backend, timeout_s, threads))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
        t_end = math.inf if deadline is None else time.monotonic() + deadline
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise _rank_error(root, bad[0], codes[bad[0]])
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > t_end:
                    raise TimeoutError(f"{nprocs} ranks did not finish within {deadline} s; killed")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return pickle.loads((pathlib.Path(root) / "result.pkl").read_bytes())


def _rank_error(root: str, rank: int, code: int) -> BaseException:
    """The error rank ``rank`` raised (unpickled), chained to a note of its
    exit code and its log."""
    path = pathlib.Path(root)
    log = path / f"rank{rank}.log"
    tail = log.read_text()[-4000:] if log.exists() else ""
    note = RuntimeError(f"rank {rank} of the spawned world failed (exit code {code})" + (f":\n{tail}" if tail else ""))
    err = path / f"error{rank}.pkl"
    if err.exists():
        try:
            exc = pickle.loads(err.read_bytes())
            exc.__cause__ = note
            return exc
        except Exception:
            pass
    return note
