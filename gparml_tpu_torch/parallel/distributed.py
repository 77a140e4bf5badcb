"""Several processes: the statistics summed over a ``torch.distributed``
process group.

Counterpart of ``gparml_tpu/parallel/distributed.py``, the reference's
remote/cluster MapReduce backend. Every process runs the same program on
its own contiguous block of rows; one ``all_reduce`` of the flattened
statistics (M^2 + M D + 4 values) per evaluation joins them. The pieces:

  * the process group (``initialize``), from explicit arguments or the
    variables ``torchrun`` sets, and its backend by a stated rule
    (``backend_for``): ``nccl`` where each rank has its own card, ``gloo``
    where ranks share a card or run on the CPU. The rule chooses; nothing
    moves to another backend when one fails;
  * the row block this process owns (``process_row_range``), built into
    padded, weighted arrays without gathering the data set
    (``shard_data_multihost``);
  * the coordinator's globals sent to every process (``broadcast_pytree``)
    and this process's rows taken back out for its partition files
    (``local_block``);
  * the bound and its gradient across processes (``value_and_grad``), and
    the optimizer's scalars (``LeafReduce``).

The gradient across processes. Every process computes the same bound F(S,
theta) of the summed statistics S = sum_r S_r, so the JAX package's
``psum`` (whose transpose is the identity) becomes two steps here: the
statistics are summed without their graph, F is differentiated on every
process, which gives dF/dS and the direct part dF/dtheta (through K_MM, its
Cholesky and beta), and dF/dS is then sent back into this process's S_r.
The replicated leaves' gradients through the statistics are summed over the
processes by a second ``all_reduce``, with the direct part added once, by
the coordinator; the latent leaves keep their own process's. (An
``all_reduce`` whose backward sums the incoming gradient, as
``torch.distributed.nn``'s does, would count dF/dS once per process, and
summing the whole gradient would count the direct part once per process.)

SVGP takes the same two stages with one partial sum, the weighted data
term S_r of this process's batch rows, and F = -(scale S - KL(theta)):
the data term's gradient summed over processes, the KL's added once.

The value F and the replicated gradients come out of that second
``all_reduce`` as the coordinator's value and one sum, so every process
holds the same bits, and the optimizer's scalars (``LeafReduce``) are one
sum over processes with the replicated leaves counted once: every process
takes the same steps and the replicated globals stay equal bit for bit.

Under a profiler the collectives of a fit open host spans
(``utils/logging.py``): ``gparml.allreduce.stats`` (the statistics),
``gparml.allreduce.grad`` (the replicated gradients and the value) and
``gparml.allreduce.scalar`` (each of ``LeafReduce``'s sums and maxima, after
this process's own reads). Each opens once the operands are ready, so it
holds the collective's host time and the wait for the other processes, not
this process's own device work. The mesh counts the bytes every
``all_reduce`` reduces (``allreduce_bytes``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gparml_tpu_torch.opt import scg
from gparml_tpu_torch.parallel.mesh import (Mesh, Sharded, pad_and_place, pad_to_multiple,
                                            replicated)
from gparml_tpu_torch.utils import logging as glog


def _dist():
    import torch.distributed as dist

    return dist


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_processes() -> int:
    """Processes on this host: ``LOCAL_WORLD_SIZE`` (``torchrun`` sets it),
    else ``WORLD_SIZE`` (one host), else 1."""
    return _env_int("LOCAL_WORLD_SIZE") or _env_int("WORLD_SIZE") or 1


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK``, else its rank."""
    found = _env_int("LOCAL_RANK")
    return found if found is not None else process_index()


def backend_for(device_type: str, processes_here: Optional[int] = None,
                cards: Optional[int] = None) -> str:
    """The process group's backend: 'gloo' on the CPU and where the
    processes on this host outnumber its cards (ranks share a card, which
    NCCL refuses); 'nccl' where each rank has a card of its own."""
    if device_type == "cpu":
        return "gloo"
    processes_here = local_processes() if processes_here is None else processes_here
    cards = torch.cuda.device_count() if cards is None else cards
    return "nccl" if processes_here <= cards else "gloo"


def local_device(device_type: str = "cuda") -> torch.device:
    """The device this process computes on: the CPU, or card LOCAL_RANK
    modulo the cards here (ranks share cards when they outnumber them)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; run on the CPU with device_type='cpu'")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: str = "cuda",
) -> None:
    """Join the process group (idempotent). Explicit arguments are used
    where given ("host:port", the world size, this process's rank), else
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK from the environment, as
    ``torchrun`` sets them. With neither, a single process needs no group
    and this returns without one. ``device_type`` is 'cuda' (the default:
    raises, as ``local_device`` does, where there is no card) or 'cpu';
    ``backend`` defaults to ``backend_for`` it; the backend in use is
    printed."""
    if is_initialized():
        return
    device = local_device(device_type)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '')}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    given = (coordinator_address, world, rank)
    if all(v is None for v in given):
        return
    if any(v is None for v in given):
        raise ValueError(
            "a process group needs the coordinator's address, the number of "
            f"processes and this process's rank; got {given} (arguments or "
            "MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)")
    backend = backend or backend_for(device_type)
    if backend == "nccl":
        torch.cuda.set_device(device)
    address = coordinator_address.removeprefix("tcp://")
    _dist().init_process_group(backend, init_method=f"tcp://{address}",
                               world_size=world, rank=rank)
    print(f"torch.distributed: rank {rank} of {world}, backend {backend} "
          f"({local_processes()} processes and {torch.cuda.device_count()} cards on "
          f"this host, {device_type})", flush=True)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_initialized():
        _dist().destroy_process_group()


def is_initialized() -> bool:
    return _dist().is_available() and _dist().is_initialized()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def is_coordinator() -> bool:
    return process_index() == 0


def backend_name() -> Optional[str]:
    """The process group's backend, or None without a group."""
    return _dist().get_backend() if is_initialized() else None


def global_mesh(device=None) -> Mesh:
    """One shard in this process, on ``device`` (default ``local_device``),
    over the process group's processes when there is a group."""
    device = local_device() if device is None else torch.device(device)
    return Mesh([device], group=_dist().group.WORLD if is_initialized() else None)


def process_row_range(n_global: int, shards_per_process: int = 1):
    """(start, stop, n_padded): the contiguous global row block THIS process
    owns. N is padded to a multiple of every shard of every process; each
    process owns an equal block of n_padded / process_count rows, rank by
    rank. Rows past n_global are padding, which the caller does not load."""
    n_proc = process_count()
    n_pad = pad_to_multiple(n_global, n_proc * shards_per_process)
    per = n_pad // n_proc
    p = process_index()
    return p * per, (p + 1) * per, n_pad


def shard_data_multihost(mesh: Mesh, n_global: int, *local_arrays, dtype=None):
    """``mesh.shard_data`` across processes: each process passes the rows of
    its own [start, stop) block (``process_row_range``; short where stop
    passes n_global, so that every padded row is on the last process) and
    gets them back padded with rows of ones and placed on its shards, with
    the 0/1 weights that keep the statistics exact. Returns (arrays...,
    weights), each a ``Sharded``."""
    start, stop, _ = process_row_range(n_global, mesh.local_size)
    return pad_and_place(mesh, stop - start, max(0, min(stop, n_global) - start),
                         local_arrays, dtype)


def replicate(mesh: Mesh, tensors):
    """The coordinator's globals (after ``broadcast_pytree``) on this
    process's home device: a list of tensors or arrays, or an
    ``nn.Module`` (moved in place)."""
    if isinstance(tensors, torch.nn.Module):
        return replicated(mesh, tensors)
    return replicated(mesh, [torch.as_tensor(t) for t in tensors])


def broadcast_pytree(tree, is_source: Optional[bool] = None):
    """The value of ``tree`` (small: numpy arrays, tuples of them) on the
    source process, returned on every process: how the coordinator's
    initial globals reach every rank (the reference wrote them to a shared
    file system). The source is the coordinator unless a process passes
    ``is_source=True``. Without a group, ``tree`` itself."""
    if not is_initialized():
        return tree
    dist = _dist()
    source = is_coordinator() if is_source is None else is_source
    flag = torch.tensor([process_index() if source else -1], device=_buffer_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    box = [tree]
    dist.broadcast_object_list(box, src=int(flag.item()))
    return box[0]


def sample_rows(m: int, seed: int, *arrays):
    """A bounded uniform subset of this process's rows of ``arrays`` (the
    same rows of each; ``init.host_candidate_rows``' size rule for M
    inducing points), gathered from every process in rank order, so that
    every process gets the whole sample. Without a group, this process's
    subset."""
    from gparml_tpu_torch.utils.init import host_candidate_rows

    n = np.asarray(arrays[0]).shape[0]
    idx = host_candidate_rows(np.arange(n)[:, None], m, seed=seed + process_index())[:, 0]
    local = [np.asarray(a)[idx] for a in arrays]
    if not is_initialized():
        return local
    parts = [None] * process_count()
    _dist().all_gather_object(parts, local)
    return [np.concatenate([part[i] for part in parts]) for i in range(len(arrays))]


def local_block(arr) -> np.ndarray:
    """This process's rows of a ``Sharded`` array or of a latent leaf, as
    numpy (for its own partition file; nothing is gathered across
    processes)."""
    if isinstance(arr, Sharded):
        arr = arr.gather("cpu")
    return arr.detach().cpu().numpy()


def barrier(name: str = "gparml") -> None:
    """A point every process reaches before any goes on (e.g. all partition
    files written before the coordinator reads them). ``name`` labels it."""
    if is_initialized():
        _dist().barrier()


def _buffer_device(mesh: Optional[Mesh] = None) -> torch.device:
    """Where a collective's buffer lives: the CPU under gloo, this process's
    card under nccl."""
    if backend_name() == "nccl":
        return mesh.home if mesh is not None else torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(flat: torch.Tensor, mesh: Mesh, op=None) -> torch.Tensor:
    """``flat`` summed (or reduced by ``op``) over the mesh's processes, on
    ``flat``'s device, its bytes counted on the mesh."""
    dist = _dist()
    buf = flat.detach().to(_buffer_device(mesh)).clone()
    mesh.allreduce_bytes += buf.numel() * buf.element_size()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op, group=mesh.group)
    return buf.to(flat.device)


def _flatten(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten(flat: torch.Tensor, like) -> list:
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].reshape(t.shape).clone())
        i += t.numel()
    return out


def _like(st, fields):
    """``fields`` in the container type of ``st``: a NamedTuple such as
    ``SufficientStats``, or a plain tuple."""
    return type(st)(*fields) if hasattr(st, "_fields") else tuple(fields)


def all_reduce_stats(st: Sequence[torch.Tensor], mesh: Mesh):
    """Partial sums (``SufficientStats``: M^2 + M D + 4 values; SVGP's
    data term: one) summed over the mesh's processes without their graph,
    in one ``all_reduce``, counted and timed on the mesh (``allreduces``,
    ``allreduce_seconds``) from a synchronized start, in a
    ``gparml.allreduce.stats`` span. Returns the same container type."""
    flat = _flatten([t.detach() for t in st])
    if flat.is_cuda:
        torch.cuda.synchronize(flat.device)
    with glog.span("gparml.allreduce.stats"):
        t0 = time.perf_counter()
        total = _all_reduce(flat, mesh)
        mesh.allreduce_seconds += time.perf_counter() - t0
    mesh.allreduces += 1
    return _like(st, _unflatten(total, st))


class _ProcessSum(torch.autograd.Function):
    """Partial sums summed over processes, for a value only. Its backward
    raises: the gradient across processes is ``value_and_grad``'s."""

    @staticmethod
    def forward(ctx, mesh, *fields):
        return tuple(all_reduce_stats(fields, mesh))

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(
            "sums over processes carry no gradient: differentiate the objective "
            "with parallel.distributed.value_and_grad (neg_bound_value_and_grad, "
            "svgp.fit), which sums the replicated leaves' gradients once")


def sum_over_processes(st, mesh: Mesh):
    """The forward of the sum over processes (``log_bound``, predictions,
    ``svgp.elbo_sharded``), in ``st``'s container type."""
    return _like(st, _ProcessSum.apply(mesh, *st))


def value_and_grad(local_stats: Callable[[], Sequence[torch.Tensor]],
                   objective: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                   leaves: Sequence[torch.Tensor], n_replicated: int,
                   mesh: Mesh):
    """(objective value, gradient of every leaf) across the mesh's
    processes. ``local_stats()`` gives this process's partial sums (the
    statistics, or SVGP's ``(data_term,)``: any tuple of tensors) with
    their graph into ``leaves``; ``objective(S)`` the objective of the sums
    over processes (it may read the replicated leaves directly: the KL, the
    bound's K_MM terms). The first ``n_replicated`` leaves are replicated
    (the globals, q(u)), the rest hold this process's rows (the latents).
    Two ``all_reduce``s: the sums, then the replicated leaves' gradients
    and the value (a ``gparml.allreduce.grad`` span)."""
    st_local = local_stats()
    st_in = _like(st_local, (t.detach().requires_grad_()
                             for t in all_reduce_stats(st_local, mesh)))
    f = objective(st_in)
    rep = list(leaves[:n_replicated])
    grads = torch.autograd.grad(f, rep + list(st_in), allow_unused=True)
    direct, d_st = grads[:n_replicated], grads[n_replicated:]
    pairs = [(t, g) for t, g in zip(st_local, d_st) if t.requires_grad and g is not None]
    through = torch.autograd.grad([t for t, _ in pairs], list(leaves),
                                  grad_outputs=[g for _, g in pairs], allow_unused=True)
    through = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, through)]
    coordinator = is_coordinator()
    parts = [g_thr + g_dir if coordinator and g_dir is not None else g_thr
             for g_thr, g_dir in zip(through, direct)]
    f_part = f.detach().reshape(1) if coordinator else torch.zeros_like(f.detach()).reshape(1)
    with glog.span("gparml.allreduce.grad"):
        summed = _all_reduce(_flatten([*parts, f_part]), mesh)
    *rep_grads, f_sum = _unflatten(summed, [*parts, f_part])
    return f_sum.reshape(()), rep_grads + through[n_replicated:]


def spans_processes(mesh: Optional[Mesh]) -> bool:
    """True for a mesh over a process group's processes."""
    return mesh is not None and mesh.group is not None


def scg_reduce(mesh: Optional[Mesh], sharded: Sequence[bool]):
    """SCG's scalars (``opt/scg.py``) for leaves under ``mesh``: summed over
    the processes of a process group's mesh, else this process's own."""
    if spans_processes(mesh):
        return LeafReduce(mesh, sharded)
    return scg.LOCAL


class LeafReduce:
    """SCG's scalars across the mesh's processes: ``dot``, ``max_abs`` and
    ``numel`` of leaf lists whose leaves are replicated (counted once, by
    the coordinator) or hold this process's rows (summed over processes).
    ``sharded[i]`` says which leaf i is. Each leaf's scalar comes to the
    host through ``scg.host_read``, a ``gparml.scg.read`` span; the
    reduction over processes is a ``gparml.allreduce.scalar`` span."""

    def __init__(self, mesh: Mesh, sharded: Sequence[bool]):
        self.mesh = mesh
        self.sharded = tuple(sharded)
        self.coordinator = is_coordinator()

    def _sum(self, per_leaf, read=float) -> np.float64:
        local = sum(read(v) for v, sh in zip(per_leaf, self.sharded)
                    if sh or self.coordinator)
        with glog.span("gparml.allreduce.scalar"):
            total = _all_reduce(torch.tensor([local], dtype=torch.float64), self.mesh)
            return np.float64(total.item())

    def dot(self, a, b) -> np.float64:
        return self._sum((torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b)),
                         read=scg.host_read)

    def max_abs(self, x) -> np.float64:
        local = max(scg.host_read(torch.max(torch.abs(t))) for t in x)
        with glog.span("gparml.allreduce.scalar"):
            total = _all_reduce(torch.tensor([local], dtype=torch.float64), self.mesh,
                                op=_dist().ReduceOp.MAX)
            return np.float64(total.item())

    def numel(self, x) -> int:
        return int(self._sum(t.numel() for t in x))


def nearest_over_processes(d2: torch.Tensor, rows: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Per new point, ``rows``' row of the process whose candidate is
    nearest (``d2``, its squared distance), the lowest rank on ties, as an
    argmin over the whole data set takes the first row."""
    dist = _dist()
    best = _all_reduce(d2, mesh, op=dist.ReduceOp.MIN)
    rank = torch.full_like(d2, float(process_index()))
    winner = _all_reduce(torch.where(d2 == best, rank, torch.full_like(d2, float("inf"))),
                         mesh, op=dist.ReduceOp.MIN)
    mine = (winner == process_index())[:, None]
    return _all_reduce(torch.where(mine, rows, torch.zeros_like(rows)), mesh)


def replicas_agree(tensors: Sequence[torch.Tensor], mesh: Mesh) -> bool:
    """True when every process holds the same bits in ``tensors`` as the
    coordinator (the replicated globals after a fit)."""
    flat = _flatten([t.detach().reshape(-1) for t in tensors])
    dist = _dist()
    ref = flat.to(_buffer_device(mesh)).clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    same = torch.tensor([int(torch.equal(ref.to(flat.device), flat))])
    same = _all_reduce(same, mesh, op=dist.ReduceOp.MIN)
    return bool(same.item())
