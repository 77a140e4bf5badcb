"""Parameter containers for the GPLVM — ``nn.Module``s whose parameters carry
the JAX pytree paths.

Counterpart of ``gparml_tpu/models/params.py``. ``GPLVMParams`` holds a
``GlobalParams`` (``glob``) and a ``LatentParams`` (``lat``), so
``named_parameters()`` yields ``glob.z``, ``glob.u_sf2``, ``glob.u_alpha``,
``glob.u_beta``, ``lat.mu`` and ``lat.u_s`` in the JAX leaf order. The
optimizer works on the list of those leaves (``leaves`` / ``from_leaves``);
the ``tree_*`` helpers act on such lists.

Latent leaves are (N, Q) in the ``nq`` layout or transposed (Q, N) in
``qn`` (``LatentParams``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from gparml_tpu_torch.utils import transforms


def _check_layout(layout: str) -> None:
    if layout not in ("nq", "qn"):
        raise ValueError(f"unknown latent layout {layout!r}; options: nq, qn")


class GlobalParams(nn.Module):
    """Replicated global parameters, unconstrained space."""

    def __init__(self, z, u_sf2, u_alpha, u_beta):
        super().__init__()
        self.z = nn.Parameter(torch.as_tensor(z).detach())          # (M, Q)
        self.u_sf2 = nn.Parameter(torch.as_tensor(u_sf2).detach())  # ()
        self.u_alpha = nn.Parameter(torch.as_tensor(u_alpha).detach())  # (Q,)
        self.u_beta = nn.Parameter(torch.as_tensor(u_beta).detach())    # ()


class LatentParams(nn.Module):
    """Per-data-point variational parameters q(x_n) = N(mu_n, diag(s_n)).

    Leaves are (N, Q) in the default layout, or transposed (Q, N) under
    ``layout='qn'`` (GPLVMConfig), the JAX package's single-device large-N
    storage. On the TPU that layout avoids the (8, 128) lane padding of
    (N, small) arrays; a GPU pads nothing, and the port keeps the layout
    because the API and the JAX package's parameters come in it and because
    (Q, N) is the layout in which the kernels' per-row reads coalesce."""

    def __init__(self, mu, u_s):
        super().__init__()
        self.mu = nn.Parameter(torch.as_tensor(mu).detach())    # (N, Q) or (Q, N)
        self.u_s = nn.Parameter(torch.as_tensor(u_s).detach())  # same layout


class GPLVMParams(nn.Module):
    def __init__(self, glob: GlobalParams, lat: LatentParams):
        super().__init__()
        self.glob = glob
        self.lat = lat


def leaves(p: nn.Module) -> list:
    """The parameter tensors in JAX leaf order (detached)."""
    return [t.detach() for t in p.parameters()]


def from_leaves(leaves_: Sequence[torch.Tensor]):
    """Rebuild params from a leaf list (the inverse of ``leaves``): 4 leaves
    give a GlobalParams, 6 a GPLVMParams."""
    glob = GlobalParams(*leaves_[:4])
    if len(leaves_) == 4:
        return glob
    return GPLVMParams(glob, LatentParams(*leaves_[4:]))


def constrain(g: GlobalParams, bijector: str = "exp"):
    """Unconstrained GlobalParams -> (z, sf2, alpha, beta) in natural space."""
    bij = transforms.get(bijector)
    return g.z, bij.forward(g.u_sf2), bij.forward(g.u_alpha), bij.forward(g.u_beta)


def constrain_latents(l: LatentParams, bijector: str = "exp",
                      layout: str = "nq", native: bool = False):
    """Unconstrained LatentParams -> (mu, s) in natural space, returned
    (N, Q) by default (transposed views out of the ``qn`` storage);
    ``native=True`` keeps the storage layout, so qn gives (Q, N)."""
    _check_layout(layout)
    mu, u_s = l.mu, l.u_s
    if layout == "qn" and not native:
        mu, u_s = mu.T, u_s.T
    return mu, transforms.get(bijector).forward(u_s)


def make_global(z, sf2, alpha, beta, bijector: str = "exp") -> GlobalParams:
    """Build GlobalParams from natural-space values."""
    bij = transforms.get(bijector)
    z = torch.as_tensor(z)
    as_z = lambda v: torch.as_tensor(v, dtype=z.dtype, device=z.device)
    return GlobalParams(
        z=z,
        u_sf2=bij.inverse(as_z(sf2)),
        u_alpha=bij.inverse(as_z(alpha)),
        u_beta=bij.inverse(as_z(beta)),
    )


def make_latents(mu, s, bijector: str = "exp", layout: str = "nq",
                 device=None) -> LatentParams:
    """Build LatentParams from natural-space (N, Q) values; ``layout='qn'``
    stores them transposed, (Q, N). Tensors are transposed on their own
    device. numpy arrays (the CLI's ``--load``) are transposed on the host,
    as the JAX package's host branch does, and copied to ``device`` (None:
    the CPU) once, in their stored layout."""
    _check_layout(layout)
    if isinstance(mu, np.ndarray):
        s = np.asarray(s, dtype=mu.dtype)
        if layout == "qn":
            mu, s = np.ascontiguousarray(mu.T), np.ascontiguousarray(s.T)
        mu, s = torch.tensor(mu, device=device), torch.tensor(s, device=device)
    else:
        mu = torch.as_tensor(mu)
        s = torch.as_tensor(s, dtype=mu.dtype, device=mu.device)
        if layout == "qn":
            mu, s = mu.T.contiguous(), s.T.contiguous()
    return LatentParams(mu=mu, u_s=transforms.get(bijector).inverse(s))


def grad_mask(
    params,
    fixed_beta: bool = False,
    fixed_embeddings: bool = False,
    fixed_z: bool = False,
    fixed_hypers: bool = False,
) -> list:
    """0/1 tensors, one per leaf of ``params``, that zero the gradients of
    fixed leaves (the reference's ``--fixed_beta`` / ``--fixed_embeddings``)."""
    glob = params.glob if isinstance(params, GPLVMParams) else params
    fixed = [fixed_z, fixed_hypers, fixed_hypers, fixed_beta or fixed_hypers]
    if isinstance(params, GPLVMParams):
        fixed += [fixed_embeddings, fixed_embeddings]
        ts = leaves(glob) + leaves(params.lat)
    else:
        ts = leaves(glob)
    return [torch.zeros_like(t) if f else torch.ones_like(t)
            for t, f in zip(ts, fixed)]


def apply_mask(grads, mask) -> list:
    return [g * m for g, m in zip(grads, mask)]


def tree_dot(a, b) -> torch.Tensor:
    """Sum over all leaves of <a_i, b_i>."""
    return sum(torch.vdot(x.reshape(-1), y.reshape(-1)) for x, y in zip(a, b))


def tree_axpy(alpha, x, y) -> list:
    """y + alpha * x, leafwise."""
    return [yi + alpha * xi for xi, yi in zip(x, y)]


def tree_scale(alpha, x) -> list:
    return [alpha * xi for xi in x]


def tree_neg(x) -> list:
    return [-xi for xi in x]


# --- interop with the JAX package's parameter pytrees ----------------------

class GlobalArrays(NamedTuple):
    z: np.ndarray
    u_sf2: np.ndarray
    u_alpha: np.ndarray
    u_beta: np.ndarray


class LatentArrays(NamedTuple):
    mu: np.ndarray
    u_s: np.ndarray


class GPLVMArrays(NamedTuple):
    """numpy mirror of the JAX ``GPLVMParams`` pytree (same fields, same
    order): ``GPLVMParams(GlobalParams(*a.glob), LatentParams(*a.lat))``
    rebuilds the JAX params from it."""

    glob: GlobalArrays
    lat: LatentArrays


def _to_tensor(device, dtype):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "from_numpy: no CUDA device; pass device='cpu' for CPU tensors")
    return lambda a: torch.tensor(np.asarray(a), device=device, dtype=dtype)


def global_from_numpy(arrays, device=torch.device("cuda"), dtype=None) -> GlobalParams:
    """Port globals from ``jax.tree.map(np.asarray, g)`` of a JAX
    GlobalParams (the SGPR parameters), or a ``GlobalArrays``: any object
    with ``.z``, ``.u_sf2``, ``.u_alpha`` and ``.u_beta``. The device rule is
    ``from_numpy``'s."""
    t = _to_tensor(device, dtype)
    return GlobalParams(t(arrays.z), t(arrays.u_sf2), t(arrays.u_alpha), t(arrays.u_beta))


def global_to_numpy(g: GlobalParams) -> GlobalArrays:
    """The inverse of ``global_from_numpy``."""
    return GlobalArrays(*(t.detach().cpu().numpy() for t in (g.z, g.u_sf2, g.u_alpha, g.u_beta)))


def from_numpy(arrays, device=torch.device("cuda"), dtype=None) -> GPLVMParams:
    """Port params from ``jax.tree.map(np.asarray, p)`` of a JAX GPLVMParams
    (or a ``GPLVMArrays``): any object with ``.glob.{z,u_sf2,u_alpha,u_beta}``
    and ``.lat.{mu,u_s}``. Leaves keep their shapes, so (Q, N) latents of a
    qn model stay (Q, N). The params go to the GPU unless ``device`` says
    otherwise (``device="cpu"``); without a GPU the default raises."""
    t = _to_tensor(device, dtype)
    return GPLVMParams(global_from_numpy(arrays.glob, device, dtype),
                       LatentParams(t(arrays.lat.mu), t(arrays.lat.u_s)))


def to_numpy(p: GPLVMParams) -> GPLVMArrays:
    """The inverse of ``from_numpy``."""
    a = lambda x: x.detach().cpu().numpy()
    return GPLVMArrays(global_to_numpy(p.glob), LatentArrays(a(p.lat.mu), a(p.lat.u_s)))
