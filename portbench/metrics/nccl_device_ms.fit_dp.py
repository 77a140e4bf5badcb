"""nccl_device_ms.fit_dp (ms): device time an evaluation spends in NCCL's
kernels on rank 0's card (names ``nccl...``; not the profiler's
``nccl:...`` annotations), over the evaluations the window completed. A
kernel waits there for the slowest rank to join."""


def _nccl(name: str) -> bool:
    return name.startswith("nccl") and not name.startswith("nccl:")


def read(r):
    evals = r.counters.get("evals")
    return 1e3 * r.trace.seconds_where(_nccl) / evals if evals else None
