"""Sufficient statistics, one entry point for the Psi engines, on one device
or summed over a data mesh.

Counterpart of ``gparml_tpu/parallel/stats.py``. ``impl`` keeps the JAX
package's names, so one config means the same thing in both packages:

  'pallas' -> the hand-written CUDA kernels (``ops/psi_cuda.py``; the
              plain versions beside them for CPU tensors),
  'xla'    -> the plain PyTorch engine (``ops/psi.py``),
  'auto'   -> 'pallas' for CUDA tensors, 'xla' for CPU tensors.

This is the entry point of the (N, Q) / (N, D) layout. The single-device
transposed layout (GPLVMConfig layout='qn') does not come through here, as
in the JAX package: ``models.gplvm`` sends it to ``psi_cuda.suff_stats_t``
(the kernels, given 'pallas', or 'auto' on CUDA tensors) or to
``psi.suff_stats_t`` (the plain engine).

With a mesh (``parallel/mesh.py``) the statistics are the JAX package's
``shard_map`` + ``psum``: each shard's block of rows goes through
``_local_stats`` on that shard's device (on CUDA tensors the kernels: one
forward and one backward call per shard per evaluation), and the shards'
statistics are summed on the mesh's home device. Every statistic is a plain
sum over rows, so the sum is exact under any partition, and it stays
differentiable into every shard: the replicated globals enter each shard
as a copy on its device, so autograd sums their gradients over the shards,
as ``shard_map``'s transpose does. Over a process group the shards' sum is
then summed over the processes (``distributed.sum_over_processes``, one
``all_reduce``); its gradient is ``distributed.value_and_grad``'s.

The TPU engine's M limit (``PALLAS_M_LIMIT``, a VMEM budget) has no
counterpart: the kernels take any M, so the JAX package's reroute past it
(and its test) has none either. The SGPR statistics (``s=None``) always
take the plain engine, as they take the XLA path in the JAX package: they
are plain matrix products.
"""

from __future__ import annotations

from typing import Optional

import torch

from gparml_tpu_torch.ops import psi, psi_cuda
from gparml_tpu_torch.parallel import distributed
from gparml_tpu_torch.parallel.mesh import Mesh, shards_of


def _local_stats(y, mu, s, z, sf2, alpha, block, weights, impl):
    if impl == "auto":
        impl = "pallas" if mu.is_cuda else "xla"
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown stats impl {impl!r}; options: auto, xla, pallas")
    if impl == "pallas" and s is not None:
        return psi_cuda.suff_stats(y, mu, s, z, sf2, alpha, weights=weights,
                                   block=block)
    return psi.suff_stats(y, mu, s, z, sf2, alpha, block=block, weights=weights)


def shard_sum(y, mu, s, z, sf2, alpha, *, mesh: Mesh, block: Optional[int] = None,
              weights=None, impl: str = "xla") -> psi.SufficientStats:
    """The statistics of this process's shards, summed on the mesh's home
    device with their graph. (y, mu, s, weights) are ``Sharded`` or (N',
    ...) tensors split into one row block per shard here; (z, sf2, alpha)
    are replicated."""
    total = None
    for dev, ys, mus, ss, ws in zip(mesh.devices, *(shards_of(mesh, a) for a in (y, mu, s, weights))):
        glob = (torch.as_tensor(t, dtype=mus.dtype).to(dev) for t in (z, sf2, alpha))
        st = _local_stats(ys, mus, ss, *glob, block, ws, impl)
        st = psi.SufficientStats(*(t.to(mesh.home) for t in st))
        total = st if total is None else total + st
    return total


def suff_stats_sharded(y, mu, s, z, sf2, alpha, *, mesh: Mesh,
                       block: Optional[int] = None, weights=None,
                       impl: str = "xla") -> psi.SufficientStats:
    """Global SufficientStats with (y, mu, s, weights) split over the mesh's
    shards and (z, sf2, alpha) replicated, on the mesh's home device.
    Differentiable within a process (``shard_sum``); over a process group
    the sum across processes has a value only (``distributed``)."""
    st = shard_sum(y, mu, s, z, sf2, alpha, mesh=mesh, block=block,
                   weights=weights, impl=impl)
    if distributed.spans_processes(mesh):
        st = distributed.sum_over_processes(st, mesh)
    return st


def suff_stats_auto(
    y, mu, s, z, sf2, alpha,
    *, mesh: Optional[Mesh] = None, block: Optional[int] = None, weights=None,
    impl: str = "xla",
) -> psi.SufficientStats:
    """Single-device or distributed sufficient statistics, one entry point:
    ``mesh=None`` is one device, a mesh the sharded sum. The JAX signature's
    Pallas ``tile`` hint has no counterpart."""
    if mesh is None:
        return _local_stats(y, mu, s, z, sf2, alpha, block, weights, impl)
    return suff_stats_sharded(y, mu, s, z, sf2, alpha, mesh=mesh, block=block,
                              weights=weights, impl=impl)
