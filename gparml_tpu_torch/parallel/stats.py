"""Sufficient statistics, one entry point for the Psi engines.

Counterpart of ``gparml_tpu/parallel/stats.py`` (``_local_stats`` and
``suff_stats_auto`` without a mesh). ``impl`` keeps the JAX package's names,
so one config means the same thing in both packages:

  'pallas' -> the hand-written CUDA kernels (``ops/psi_cuda.py``; the
              plain versions beside them for CPU tensors),
  'xla'    -> the plain PyTorch engine (``ops/psi.py``),
  'auto'   -> 'pallas' for CUDA tensors, 'xla' for CPU tensors.

This is the entry point of the (N, Q) / (N, D) layout. The single-device
transposed layout (GPLVMConfig layout='qn') does not come through here, as
in the JAX package: ``models.gplvm`` sends it to ``psi_cuda.suff_stats_t``
(the kernels, given 'pallas', or 'auto' on CUDA tensors) or to
``psi.suff_stats_t`` (the plain engine).

The TPU engine's M limit (``PALLAS_M_LIMIT``, a VMEM budget) has no
counterpart: the kernels take any M. The SGPR statistics (``s=None``)
always take the plain engine, as they take the XLA path in the JAX
package: they are plain matrix products. Data-parallel statistics over a
mesh are not ported yet (ROADMAP.md Queue 1, item 3).
"""

from __future__ import annotations

from typing import Optional

from gparml_tpu_torch.ops import psi, psi_cuda


def _local_stats(y, mu, s, z, sf2, alpha, block, weights, impl):
    if impl == "auto":
        impl = "pallas" if mu.is_cuda else "xla"
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown stats impl {impl!r}; options: auto, xla, pallas")
    if impl == "pallas" and s is not None:
        return psi_cuda.suff_stats(y, mu, s, z, sf2, alpha, weights=weights,
                                   block=block)
    return psi.suff_stats(y, mu, s, z, sf2, alpha, block=block, weights=weights)


def suff_stats_auto(
    y, mu, s, z, sf2, alpha,
    *, mesh=None, block: Optional[int] = None, weights=None,
    impl: str = "xla",
) -> psi.SufficientStats:
    """Single-device sufficient statistics; ``mesh`` raises. The JAX
    signature's Pallas ``tile`` hint has no counterpart."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel statistics over a mesh are not ported yet "
            "(ROADMAP.md Queue 1, item 3: parallel)")
    return _local_stats(y, mu, s, z, sf2, alpha, block, weights, impl)
