"""psi_roofline.fit (%): the least time the card could take for one
evaluation's Psi forward and backward work, over the device time an
evaluation spends in the program's ``gparml::`` kernels.

The least time is the larger of the work's float32 operations over the
dense TF32 tensor-core peak and its bytes over the memory rate
(``work.psi_work``, ``peaks.json``): no float32-accurate kernel outruns
either. The kernels are found by their namespace in the trace, so a renamed
or added kernel still counts.
"""

from portbench.work import psi_work


def read(r):
    c, peaks = r.counters, r.peaks
    if peaks is None or not c.get("evals"):
        return None
    kernel_s = r.trace.seconds_where(lambda name: "gparml::" in name) / c["evals"]
    if kernel_s <= 0:
        return None
    shape = (c["n"], c["m"], c["q"], c["d"])
    ops = psi_work("fwd", *shape)[0] + psi_work("bwd", *shape)[0]
    nbytes = psi_work("fwd", *shape)[1] + psi_work("bwd", *shape)[1]
    least = max(ops / peaks["tf32_flops"], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / kernel_s
