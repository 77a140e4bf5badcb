"""The data mesh and the sharding helpers.

Counterpart of ``gparml_tpu/parallel/mesh.py``. The JAX package's 1-D
``jax.sharding.Mesh`` over the data axis plays the role of the reference's
worker pool; here a ``Mesh`` lists this process's shards, each on a torch
device, and (under ``parallel.distributed``) the process group whose
processes hold the other shards. N-sized arrays are split by rows into one
block per shard (``shard_data``): the reference's per-partition files.

A device may appear more than once: ``Mesh(["cpu"] * 8)`` runs eight
shards one after another on the CPU, and ``Mesh(["cuda:0"] * 4)`` four on
one card. That is the counterpart of the JAX tests' eight virtual CPU
devices (``jax_num_cpu_devices=8``): the CPU tests and ``chip_smoke.py``
use it to run the sharded path where there is one device. ``make_mesh``
spans the visible CUDA devices, one shard each.

Layout of a sharded model: Y and the weights are placed once, shard by
shard, as ``Sharded`` row blocks. The latent leaves stay one (N', Q)
tensor on the mesh's home device (its first), which the statistics slice
per shard at every evaluation, so the optimizers and the checkpoints see
the same leaves as without a mesh. The replicated globals live on the home
device too and are copied to each shard's device inside the evaluation,
so their gradients sum over the shards through autograd.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"


class Mesh:
    """A 1-D data mesh over the axis ``DATA_AXIS``: ``devices``, this
    process's shards in row order (one may repeat), and ``group``, the
    ``torch.distributed`` process group the statistics are summed over
    (None: this process alone). Processes hold equal row blocks, in rank
    order."""

    def __init__(self, devices: Sequence, group=None):
        if len(devices) == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group
        # the statistics' all_reduces over the processes: how many, and
        # their host seconds from a synchronized start (distributed.py)
        self.allreduces = 0
        self.allreduce_seconds = 0.0
        # the bytes of every all_reduce over the processes (the statistics,
        # the gradients and value, the optimizer's scalars)
        self.allreduce_bytes = 0

    @property
    def home(self) -> torch.device:
        """Where the latent leaves, the globals and the summed statistics
        live: the first shard's device."""
        return self.devices[0]

    @property
    def local_size(self) -> int:
        """Shards in this process."""
        return len(self.devices)

    @property
    def num_processes(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Shards over every process (the JAX mesh's ``devices.size``)."""
        return self.local_size * self.num_processes

    def __repr__(self) -> str:
        procs = f", {self.num_processes} processes" if self.group is not None else ""
        return f"Mesh({[str(d) for d in self.devices]}{procs})"


class Sharded:
    """An (N', ...) array held as row blocks, block i on ``mesh.devices[i]``
    (the JAX package's array under ``data_sharding``)."""

    def __init__(self, mesh: Mesh, shards: Sequence[torch.Tensor]):
        if len(shards) != mesh.local_size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.local_size}")
        self.mesh = mesh
        self.shards = tuple(shards)

    @property
    def shape(self) -> torch.Size:
        first = self.shards[0]
        return torch.Size((sum(t.shape[0] for t in self.shards), *first.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def ndim(self) -> int:
        return self.shards[0].ndim

    def gather(self, device=None) -> torch.Tensor:
        """The whole array on ``device`` (default: the mesh's home)."""
        device = self.mesh.home if device is None else torch.device(device)
        return torch.cat([t.to(device) for t in self.shards], dim=0)


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D data mesh over the first ``n_devices`` visible CUDA devices, one
    shard each (all of them by default). Raises when more are asked for
    than exist, as the JAX function does."""
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n > count or n < 1:
        raise ValueError(f"requested {n} CUDA devices, {count} available")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _rows(mesh: Mesh, a: torch.Tensor):
    """``a``'s rows in one equal block per shard, each block a contiguous
    tensor on its shard's device (differentiable copies)."""
    k = mesh.local_size
    if a.shape[0] % k:
        raise ValueError(f"{a.shape[0]} rows do not split over {k} shards; "
                         "pad them first (shard_data)")
    return [b.to(dev).contiguous() for b, dev in zip(torch.split(a, a.shape[0] // k), mesh.devices)]


def data_sharding(mesh: Mesh, a) -> Sharded:
    """Place an (N', ...) tensor's rows shard by shard (N' a multiple of
    the mesh's local size). A ``Sharded`` is returned as it is."""
    if isinstance(a, Sharded):
        return a
    return Sharded(mesh, _rows(mesh, torch.as_tensor(a)))


def shards_of(mesh: Mesh, a):
    """The per-shard blocks of ``a``: a ``Sharded``'s own, or a tensor's rows
    split and copied at this call (how the latent leaves enter)."""
    if a is None:
        return [None] * mesh.local_size
    if isinstance(a, Sharded):
        if a.mesh.devices != mesh.devices:
            raise ValueError(f"array sharded over {a.mesh}, evaluated over {mesh}")
        return list(a.shards)
    return _rows(mesh, a)


def replicated(mesh: Mesh, tensors):
    """An ``nn.Module`` (moved in place) or a list of tensors on the mesh's
    home device, where the replicated globals live."""
    if isinstance(tensors, torch.nn.Module):
        return tensors.to(mesh.home)
    return [t.to(mesh.home) for t in tensors]


def pad_and_place(mesh: Mesh, n_rows: int, n_valid: int, arrays, dtype=None):
    """Each array (numpy, as ``dtype``, or a tensor) of ``n_valid`` rows
    padded to ``n_rows`` with rows of ones and placed shard by shard, and
    the (n_rows,) 0/1 weights that keep the statistics exact: (Sharded...,
    weights)."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a, dtype=dtype) if torch.is_tensor(a) else torch.tensor(
            np.asarray(a), dtype=dtype)
        if t.shape[0] != n_valid:
            raise ValueError(f"an array has {t.shape[0]} rows, expected {n_valid}")
        if n_rows != n_valid:
            t = torch.cat([t, torch.ones((n_rows - n_valid, *t.shape[1:]), dtype=t.dtype,
                                         device=t.device)])
        out.append(data_sharding(mesh, t))
    w = torch.zeros(n_rows, dtype=out[0].dtype)
    w[:n_valid] = 1.0
    out.append(data_sharding(mesh, w))
    return tuple(out)


def shard_data(mesh: Mesh, *arrays, dtype=None):
    """Pad the leading axis to a multiple of the mesh's local size with rows
    of ones, place each array shard by shard, and return (padded arrays...,
    weights): the weights are the (N',) 0/1 mask that keeps the sufficient
    statistics exact under padding, as in the JAX package. Every result is
    a ``Sharded``, its blocks on the mesh's devices."""
    n = arrays[0].shape[0]
    return pad_and_place(mesh, pad_to_multiple(n, mesh.local_size), n, arrays, dtype)
