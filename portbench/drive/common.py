"""What the drivers share: the model of a configuration file, made from the
seed on the device, and the reference's view of the program's parameters."""

from __future__ import annotations

import gc

import torch

from portbench import data
from portbench.reference import gplvm as ref
from portbench.reference import init as ref_init

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# offsets of the seed of each independent stream of draws
DATA_STREAM, INIT_STREAM = 0, 1


def gplvm_config(cfg: dict):
    from gparml_tpu_torch.models import gplvm
    return gplvm.GPLVMConfig(
        q=cfg["q"], num_inducing=cfg["m"], bijector=cfg["bijector"], jitter=cfg["jitter"],
        stats_impl=cfg["stats_impl"], init=cfg["init"], layout=cfg["layout"],
        y_layout=cfg["y_layout"], s0=cfg["s0"])


def observations(cfg: dict, seed: int, device, extra_rows: int = 0):
    """(Y in the configuration's layout, the extra rows (extra, D)): one draw
    of N + extra rows, so that both come from one distribution."""
    gen = data.generator(seed * 2 + DATA_STREAM, device)
    y = data.oil_flow_like(gen, cfg["n"] + extra_rows, cfg["d"], DTYPES[cfg["dtype"]])
    y_train, extra = y[:cfg["n"]], y[cfg["n"]:]
    if cfg["y_layout"] == "dn":
        y_train = y_train.T.contiguous()
    return y_train, extra


def init_generator(seed: int, device) -> torch.Generator:
    return data.generator(seed * 2 + INIT_STREAM, device)


def host_leaves(p) -> list:
    """A host copy of the program's parameter leaves (they are judged after
    the window, and a copy on the card would count in its peak)."""
    return [t.detach().to("cpu", copy=True) for t in p.parameters()]


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The device allocator's peak over the run (0 off the card, where the
    tests drive a run)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class RefModel:
    """The reference's float64 view of the program's rows and leaves."""

    def __init__(self, cfg: dict, y, device):
        self.cfg, self.device = cfg, device
        self.y = ref.rows_of_y(y, cfg["y_layout"], torch.float64)
        self.jitter = ref.effective_jitter(cfg["jitter"], DTYPES[cfg["dtype"]])
        self.psi2_eps = ref.psi2_eps_of(DTYPES[cfg["dtype"]])
        self.d = cfg["d"]

    def split(self, leaves, dtype=None):
        """(Globals, mu rows, u_s rows) of host leaves, on the device."""
        dtype = dtype or torch.float64
        lv = [t.to(self.device) for t in leaves]
        return (ref.globals_of(lv, dtype), ref.to_rows(lv[4], self.cfg["layout"], dtype),
                ref.to_rows(lv[5], self.cfg["layout"], dtype))

    def start_gap(self, leaves0, control: bool = False) -> float:
        """The start's gap from its definition; ``control`` replaces the
        program's latents by the reference's own principal components in
        float32 with TF32 products."""
        g, mu, u_s = self.split(leaves0)
        if control:
            ref.set_precision(True)
            mu = ref_init.pca(self.y.float(), self.cfg["q"]).double()
            ref.set_precision(False)
        return ref_init.start_gap(self.y, mu, u_s, g.u_sf2, g.u_alpha, g.u_beta, self.cfg["s0"])
