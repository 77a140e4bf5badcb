"""Checkpoint / resume for parameter modules.

Counterpart of ``gparml_tpu/checkpoint.py``: one ``.npz`` file holds every
leaf of the parameters, keyed by the JAX package's tree path, plus a JSON
metadata blob under ``__gparml_meta__`` (config echo, iteration count,
bound value); no pickling. The port's ``nn.Module`` parameter names map to
those keys by their separator: ``glob.z`` is ``glob/z``, ``lat.u_s`` is
``lat/u_s``. So a checkpoint written by either package loads in the other.
The file is written to a temporary name and then renamed over ``path``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gparml_tpu_torch.models import params as P
from gparml_tpu_torch.models import svgp

_META_KEY = "__gparml_meta__"


def _key(name: str) -> str:
    """The JAX tree path of the parameter ``name``."""
    return name.replace(".", "/")


def save(path: str, params: nn.Module, meta: Optional[Dict[str, Any]] = None) -> None:
    """Save the parameters of ``params`` (+ JSON-serializable metadata) to
    ``path``."""
    arrays = {_key(k): v.detach().cpu().numpy() for k, v in params.named_parameters()}
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def holds_latents(path: str) -> bool:
    """True when the checkpoint at ``path`` holds latent leaves (``lat/...``);
    a ``-p remote`` run's checkpoint holds the globals only."""
    with np.load(path) as f:
        return any(k.startswith("lat/") for k in f.files)


def load(path: str, like: nn.Module) -> Tuple[nn.Module, Dict[str, Any]]:
    """Load a checkpoint into the structure of ``like`` (a GPLVMParams,
    GlobalParams or SVGPParams template with the same parameter names; a
    GlobalParams template also takes the globals of a GPLVM or SVGP
    checkpoint). Shapes must match the template's; the dtypes come from the
    file and the device from the template.

    Returns (params, meta).
    """
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    meta_raw = arrays.pop(_META_KEY, None)
    meta = (
        json.loads(bytes(meta_raw.tobytes()).decode("utf-8"))
        if meta_raw is not None
        else {}
    )
    leaves = []
    for name, leaf in like.named_parameters():
        key = _key(name)
        if key not in arrays and isinstance(like, P.GlobalParams):
            key = "glob/" + key   # the globals of a GPLVM or SVGP checkpoint
        if key not in arrays:
            raise KeyError(
                f"checkpoint {path} is missing leaf {key!r}; has {sorted(arrays)}"
            )
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint {path} leaf {key!r} has shape {arr.shape}, "
                f"expected {tuple(leaf.shape)}: wrong N/Q/M configuration?"
            )
        leaves.append(torch.tensor(arr, device=leaf.device))
    if isinstance(like, svgp.SVGPParams):
        return svgp.from_leaves(leaves), meta
    return P.from_leaves(leaves), meta
